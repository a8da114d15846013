#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`tfde_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. device — the card's name and power limit from nvidia-smi;
2. build  — compile every kernel source of the serving and training paths
   (tfde_tpu_torch/csrc/flash_fwd.cu, flash_bwd.cu) with nvcc (sm_90a),
   one nvcc per source, all started together; count each bf16 kernel's
   wgmma (HGMMA), TMA (UTMALDG) and mma.sync (HMMA) instructions in
   `cuobjdump -sass` at each head dim, 64, 128 and 256 (the forward, dK/dV
   and dQ kernels must have wgmma and TMA and no mma.sync), and time one
   tensor-map encode on the host;
3. kernels — each kernel against its plain PyTorch version on the card,
   over the slice shape and the option matrix (the forward's out and lse;
   the backward pair's dq, dk and dv; at the slice shape and one GQA case
   two backward calls must give the same bits), then its time beside the
   plain version's, the library call's (SDPA's forward, SDPA's backward;
   timing only) and the bound; then the three bf16 kernels at D 128; then
   at D 256 (cases of the option matrix above, fp32 among them, and 160
   zero-padded), timed at Gemma-2-2B's shapes: the forward at its prefill
   ([1, 4096, 8 -> 4 KV heads, 256], window 4096, cap 50, scale 1/16),
   the backward pair at [2, 1024, 8 -> 4, 256] with the cap;
4. parity — a small fp32 GPT with head_dim 64: logits of the CUDA model
   (flash prefill) against the same weights on the CPU (plain attention),
   and the CUDA batcher's greedy tokens against CPU `generate`;
5. train parity — the same kind of GPT takes one next_token_loss + AdamW
   step on CUDA (flash forward and backward kernels) and on the CPU
   (plain versions): loss, every gradient and the updated parameters;
   then a 2-layer GPT with head dim 256 (Gemma-2's fields) takes three
   steps in fp32 on the card and on the CPU (every loss, the final
   parameters) and in bf16 on the card, the counters zeroed just before:
   each D-256 kernel once a layer a step;
6. serve  — GPT-2 small at full width (768 x 12 layers, 12 heads, MLP
   3072, vocab 50257, 1024 positions, bf16, random weights from seed 0)
   behind a ContinuousBatcher (batch 8, max_len 1024, scan depth 4,
   greedy) answering 16 requests of 16-960 prompt tokens x 32 new tokens;
   the launch counters are zeroed just before and read just after, and
   the flash kernel must have run 12 times per prefill wave; then one
   wave's first-token logits with attn_impl flash vs reference;
7. train  — GPT-2 small at full width, fp32 master weights, bf16 compute,
   random weights from seed 0, 20 steps of batch 8 x 1024 tokens of
   `synthetic_tokens` (masked AdamW, lr 3e-4, warmup 5, cosine over 20,
   weight decay 0.1); the counters are zeroed just before and read just
   after: each of the three kernels must have run 12 x 20 times, every
   loss must be finite and the last below the first;
8. dp     — data parallelism on a one-rank NCCL group: BatchNormCNN under
   MultiWorkerMirroredStrategy (DDP) on CUDA against the CPU for five
   sgd(0.05) steps, in fp32 and in fp64 (and whether fp32 card runs repeat
   their bits, with cuDNN's default algorithms and deterministic ones);
   the reference recipe (global batch 128, sgd(0.2,
   momentum 0.9), 300 steps of synthetic MNIST) with ms per step, images/s
   and memory, its loss below 0.1 and the 10000 test images, the last
   batch ragged and masked, at accuracy >= 0.95; on a machine with more
   than one card, one process a card on NCCL (parity against the CPU, the
   same bits on every rank, the recipe's ms per step and its scaling
   efficiency against the same worker as one rank on one card); then, the group destroyed, `python -m
   tfde_tpu_torch.mnist_multiworker --device cuda` as a user runs it
   (PlainCNN through `Dataset` -> `device_prefetch` -> `Estimator.train`,
   15 steps). It runs none of the flash kernels;
9. lifecycle — the Estimator on the card (`testing.recipe`): the dp
   recipe (BatchNormCNN at the reference widths, dropout 0.5, seed 0,
   `cudnn.deterministic`, global batch 128, sgd(0.2, momentum 0.9)) from
   `Dataset.from_tensor_slices(train).shuffle(60000, seed=0).repeat()
   .batch(128)` through `device_prefetch` (pinned staging, a copy stream)
   and `Estimator.train` to step 300 on a one-rank NCCL group, a
   checkpoint every 100: its ms per step over steps 11-100 beside the dp
   phase's old loop and the old loop again under `cudnn.deterministic`,
   the feed's blocking share of that window, the feed alone (inline, and
   with `background=True`, whose batches must equal the inline feed's),
   and the device's idle share over 20 steady steps of a resumed run;
   `Estimator.evaluate` of the 10000 test images in
   batches of 768 at accuracy >= 0.95; a checkpoint's bytes, save and
   restore ms; a child process (`python -m tfde_tpu_torch.testing`)
   that raises SIGTERM in itself after step 150 must die by the signal
   with its newest checkpoint at 150, and a run resuming it to 300 must
   end with every parameter and buffer of the uninterrupted run, bit for
   bit; `mnist_multiworker.main` with `--model-dir`, `--epochs 2` then
   3, must resume at step 10 and end at 15; GPT-2 small (bf16 compute)
   through the Estimator with `loss_fn`/`eval_fn`, 4 steps with a
   checkpoint every 2 and a fresh Estimator resuming to 6, must end with
   the bits of 6 uninterrupted steps, each run launching each flash
   kernel 12 times a step (counters zeroed just before each run). Every
   model_dir lies under build/ and is removed at the end;
10. export — the reference's two Estimator recipes and the serving export:
   `python -m tfde_tpu_torch.mnist_estimator --working-dir D --num-epochs
   1 --no-tensorboard` in a child process, as a user runs it (TF32 off
   through ``NVIDIA_TF32_OVERRIDE=0``; BatchNormCNN at the reference
   widths, batch 128, 468 steps under ParameterServerStrategy, at one
   process without a group), which must exit 0 with a checkpoint at 468,
   one artifact under D/export/exporter and a finite final eval; its ms
   per step from the logged steps/sec beside the dp phase's; the artifact
   served on the card (`load_serving`) at batch sizes 1, 7, 128 and 10000
   against the model restored from the checkpoint (softmax on the card)
   and against the same artifact served on the CPU, each within 1e-5, and
   its argmax accuracy over the 10000 test images against the final eval
   accuracy within 1e-4; the seconds and bytes of an export and the served
   and live ms of a batch of 128; `train_and_evaluate` with a
   BestExporter over the evals after steps 1 and 2 and the final one,
   whose newest artifact must be the one best_metric.json names;
   `python -m tfde_tpu_torch.mnist_tf2 --custom-loop --max-steps 100`
   and `--model-dir D2 --max-steps 200`, two child processes run
   together beside the GPT export check below (none of the three is
   timed against another reading), each exiting 0 at its step count with
   a finite loss; a bf16 GPT whose forward launches the flash
   kernel exports from the card (the kernels are `torch.library` ops, so
   the trace records them and launches nothing), and its artifact,
   loaded in a fresh process on the card, launches the kernel once a
   layer and gives the live model's logits bit for bit; on a machine
   with two cards or more, ParameterServerStrategy
   one process a card on NCCL against the mirrored run (the same bits on
   every rank, each rank's optimizer-state bytes: 296,264 at four). It
   runs none of the flash kernels but the exported GPT's. Every directory
   lies under build/ and is removed at the end;
11. resnet — CIFAR-10 ResNet-50 and the host input pipeline: the native
   loader's library built with g++ (seconds); one epoch of the 50,000
   training rows through NativeBatchLoader (batch 128, seed 0) holding
   every row once (label counts, a multiset of row fingerprints), its
   batches/s beside the Dataset path's; the native crc32c equal to the
   table walk on 1 MiB, both rates; the rows as 8 TFRecord shards, one
   epoch through StreamingTFRecordLoader (window 8192, seed 0) and
   device_prefetch to the card, the same multiset, records/s; a tiny
   ResNet of each block (stage_sizes [1, 1], 16 filters, CIFAR stem, fp32,
   TF32 off) on the card against the CPU on the same weights: eval logits,
   and one make_train_step as DDP on a one-rank NCCL group (loss, every
   gradient, the updated parameters and statistics, DP_TOL), with cuDNN's
   default algorithms and under cudnn.deterministic; the bf16 model's
   logits; `resnet50_cifar` (bf16 trunk, fp32 master weights, seed 0) from
   `cifar10_resnet.make_train_dataset(128, use_native=True)` through
   `Estimator.train` under MultiWorkerMirroredStrategy on a one-rank NCCL
   group for 200 steps of the entry point's schedule (ms per step and
   images/s over steps 51-200, memory, the feed's blocking share, every
   loss finite and the last 20 below the first 20 on average), 10 more
   profiled (the idle share, the top device operations, the all-reduces a
   step), the flash counters zeroed just before and 0 after; then
   `python -m tfde_tpu_torch.cifar10_resnet --max-steps 20` in a child
   process, which must exit 0 at step 20, fed by the native loader. It
   runs none of the flash kernels. Every file lies under build/ and is
   removed at the end;
12. bert — BERT-base MLM (BASELINE config 5): the three bf16 kernels
   against their plain versions at BERT's attention shape ([64, 128, 12,
   64], non-causal, unmasked), forward and backward, and their times
   beside the plain versions', SDPA's and the bounds; bert_tiny_test
   (fp32, dropout 0) for three custom MLM steps as DDP on a one-rank
   NCCL group against the CPU (ENC_TOL); BertBase at the published widths
   (vocab 30522, 12 x 768, 12 heads, MLP 3072, bf16 compute, fp32 master
   weights, dropout 0.1, random weights from seed 0) through
   `bert_mlm.main` on a one-rank NCCL group for BERT_STEPS steps of 64 x
   128 tokens + BERT_PROFILED profiled (ms a step, tokens/s, the idle
   share, memory, the losses at steps 1 and 100, which must fall), the
   counters zeroed just before and read just after: each kernel 12 times
   a step; then `python -m tfde_tpu_torch.bert_mlm --max-steps 20` in a
   child process;
13. vit — ImageNet ViT-B/16 under FSDP (BASELINE config 4): the three
   kernels at ViT's shape ([256, 197, 12, 64]: two Q tiles, the second of
   69 rows); vit_tiny_test for three AdamW steps under FSDPStrategy
   (FSDP2 on a one-rank NCCL group) against the CPU; ViT_B16 (224 px,
   1000 classes, dropout 0.1, bf16 compute, fp32 master weights, seed 0)
   at batch VIT_BATCH from the native loader through `Estimator.train`
   under FSDPStrategy for VIT_STEPS steps + VIT_PROFILED profiled (ms a
   step, images/s, the idle share, memory, the feed's blocking share, the
   FSDP collectives a step, this rank's parameter and optimizer bytes;
   the mean loss of the last 10 steps below the first 10's), each kernel
   12 times a step; on a machine with two cards or more, one process a
   card under FSDP on NCCL (`testing.fsdp_ranks_worker`: parity with the
   CPU, the same gathered parameters on every rank, each rank's parameter
   elements and optimizer bytes); then `python -m
   tfde_tpu_torch.imagenet_vit --max-steps 10` in a child process. Every
   file lies under build/ and is removed at the end. The entry points'
   children of phases 11-13 (cifar10_resnet, bert_mlm, imagenet_vit) are
   queued and run together after phase 13, so that none overlaps another
   phase's timed work (since PR 17, to keep the script inside its time
   limit);
14. gpt_lm — GPT pretraining with rotary positions, grouped-query
   attention, the sliding window, remat and packing: a small fp32 GPT
   (head dim 64, rope, 2 KV heads of 4, window 24, remat 'full') on the
   card against the CPU on the same weights (prefill logits, the
   batcher's greedy tokens against CPU `generate`, one next_token_loss +
   AdamW step: loss, every gradient, the updated parameters; the flash
   forward twice a layer); GPT-2 small at full width (bf16 over fp32
   master weights, random weights from seed 0) through `gpt_lm.main
   --rope --kv-heads 4 --sliding-window 256 --remat` for 20 steps of 8 x
   1024 tokens (warmup 5), the counters zeroed just before and read just
   after: 24 forward, 12 dK/dV and 12 dQ launches a step, every loss
   finite and the last below the first, ms a step, tokens/s, memory,
   then 3 more steps profiled; the same model without the window through
   `gpt_lm.main --packed --rope --kv-heads 4 --remat` for 10 steps (no
   flash launch: the segment mask takes the reference einsum; ms a step,
   the fill share, memory); the three bf16 kernels at the slice's GQA +
   window shape ([8, 1024, 12 -> 4 KV heads, 64], causal, window 256)
   against their plain versions, timed beside their band-aware bounds
   and SDPA (`enable_gqa`, the band as a boolean mask; timing only); then
   `bert_mlm.main --remat` for 10 steps on a one-rank NCCL group: 24
   forward launches a step; then GPT-2 small through `gpt_lm.main
   --generate 32 --export-generate DIR --temperature 0` (3 steps, then 32
   greedy tokens after two 16-token prompts, exported as a generative
   artifact), the artifact loaded in a fresh process on the card: the
   same tokens, the flash prefill once a layer on both sides;
15. hf_serve — converted checkpoints (`models/convert.py`, `serve_gpt
   --hf-dir`): one small GPT per group of decoder fields
   (`testing.FIELD_GROUPS`: Llama, Qwen3, Qwen2, Gemma-2, Phi at head dim
   80, NeoX, BigCode with one KV head, OPT; random weights from seed 0)
   through `save_converted` -> `load_converted`, its prefill logits on
   the card (flash, once a layer) in fp32 and in bf16 against the same
   artifact in fp32 on the CPU (`HF_TOL`), and the card's fp32 batcher's
   greedy tokens against CPU `generate`; then Llama-3.2-1B and Qwen3-0.6B
   at their published widths (`testing.FULL_WIDTH`, random weights from
   seed 0, fp32 master weights), Qwen3-0.6B written with `save_converted`
   (seconds, bytes), served by `serve_gpt.main(["--hf-dir", ...])` (16
   requests) and loaded again (seconds), Llama-3.2-1B built on the card
   from seed 0 without that round trip; each served in bf16 behind a
   ContinuousBatcher as in the serve phase (16 requests of 16-960 prompt
   tokens x 8, `HF_NEW`, cut from 32, then 16, for the time limit; the
   counters zeroed just before: one forward launch a layer a prefill
   wave; tokens/s, mean TTFT, ms per output token, peak memory), one
   wave's first-token logits flash vs reference (held in fp32,
   `HF_WAVE_TOL`; in bf16 each path against the fp32 einsum, flash held
   to `HF_BF16_RATIO` times the einsum's error), and the first four
   requests' greedy tokens from the batcher against `generate` on the
   card, held in fp32 (bf16's are counted: bf16 greedy decoding is not
   batch-invariant); then the forward kernel at the two prefill shapes
   ([1, 4096, 32 -> 8 KV heads, 64] and [1, 4096, 16 -> 8, 128], bf16,
   causal) against its plain version, three timed calls beside the plain
   version, SDPA (`enable_gqa`) and the bound. Gemma-2-2B (head dim 256,
   26 layers, the caps, the alternating window 4096) is served the same
   way from its published widths, built on the card from seed 0 without
   the artifact round trip (`save_converted` and `--hf-dir` are held on
   the two above; its fp32 artifact would be ~10.5 GB): the batcher's
   D-256 forward launches exactly 26 a prefill wave, the fp32 and bf16
   logit holds and the fp32 tokens. Every artifact lies under build/ and
   is removed at the end;
16. prefix_paged — the prefix-KV cache and paged KV in the batcher:
   Llama-3.2-1B at its published widths (random weights from seed 0,
   built on the card) behind a ContinuousBatcher (batch 8, max_len 1024,
   scan depth 4) answering 24 requests x 16 new tokens (`PP_NEW`, cut
   from 32 in PR 17), each a shared
   512-token system prompt + 16-256 tokens, four of them repeating an
   earlier request's whole prompt; in fp32 (a) dense, (b) dense with the
   prefix cache, (c) paged with the trie, (d) paged with the trie, the
   pool cut to two max-length rows (131 blocks) and the trie to 40
   blocks, ``TFDE_KV_DEFRAG_THRESHOLD=0.1``: every request's greedy
   tokens equal across (a)-(d) and the first four's to `generate` (a
   mismatch prints the top-2 logit margin where the runs part); the
   counters zeroed just before each run: flash forward launches exactly
   16 a cold wave ((a) and (b)), 0 in (c) and (d); (b) and (c) admit
   requests warm with >= 512 reused tokens each, (d) evicts from the trie
   and defragments the pool at a stall; after (c)'s first warm wave every
   row's table gathered into position order equals (b)'s dense cache over
   its committed cells (`PP_GATHER_TOL`); then (a)-(c) in bf16 (token
   differences counted). Each run prints tok/s, TTFT cold and warm
   (whole, and after the queue), ms per output token, prefill and decode
   seconds, ms per tick, peak memory, the trie's and the pool's counts
   and the KV ledger (`kv_stats()`).
   Then int8 KV (``kv_quant='int8'``) at the same traffic: (e) dense,
   (f) paged with the trie, (g) paged with the trie, the pool cut to the
   bytes of (d)'s 131 fp32 blocks (493 int8 blocks) and the trie to (d)'s
   bytes, in fp32, and bf16 (e) dense. Held: each run's flash launches
   equal its fp twin's ((a), (c), (d), bf16 (a)), 16 a cold wave in the
   dense runs: the cold wave prefills on the kernel over the dequantized
   K/V; (e)'s layer-0 int8 payload and scales equal bit for bit
   `kv_quantize` on the card of (a)'s fp32 layer-0 cache over the prompt
   cells of the rows resident at the end; the greedy-match rate against
   the twin printed, not held (JAX accepts >= 0.98; random weights' top-2
   margins are smaller than the int8 logit error), and in fp32 every
   request parting from its twin only where the int8 function explains
   it: the twin's top-2 margin at most twice the int8 logit error there,
   and the run's token the int8 function's top one (`PP_MATCH_FLOOR`);
   once every row is busy (with a prefix cache: once a warm row is
   busy), `kv/used_bytes` within 1% of the live cells' bytes counted
   from the cache tensors (every run, fp and int8); (g) holds 4D / (D + 4) = 3.76x (d)'s blocks in no more bytes and
   stalls fewer times. On idle dense batchers: the slabs' bytes (int8 /
   fp32 = 68/256, int8 / bf16 = 68/128) and, under
   ``TFDE_CAPACITY_BUDGET_BYTES=134217728``, headroom 2 rows / 2,048
   tokens in fp32 and 7 rows / 7,710 tokens in int8;
17. admission — admission control and the prefill/decode role split:
   Llama-3.2-1B at its published widths (random weights from seed 0,
   built on the card), 16 primed + 8 plain requests of 100-900 prompt
   tokens x 8 new (`AD_NEW`, cut from 16 in PR 17). In fp32, for fp and
   int8 KV: a prefill replica
   (`role='prefill'`, batch 1) primes the 16 (each `prime()` must launch
   the forward once a layer, 16 times; ms a request, payload bytes a
   prompt token held at 65,536 fp32 / 17,408 int8), each payload crosses
   `primed_to_json` / `primed_from_json` (bit for bit; bytes, encode and
   decode ms), every prompt runs alone on a 'both' batcher (batch 1),
   whose slab row after the cold admission must equal the shipped planes
   bit for bit; then a decode replica (`role='decode'`, batch 8, max_len
   1024, scan depth 4) admits the 16 primed beside the 8 plain, dense and
   paged: every request's greedy tokens equal its solo run, each primed
   wave launches no forward and each cold wave 16; waves by kind (ms),
   TTFT primed vs plain, `drain_rate_tps` against the tokens/s of the
   same rounds. In bf16: the same priming (32,768 bytes a token), the
   dense decode replica, and the primed waves' ms against the same
   requests' cold waves. Then every admission scenario of the JAX tests
   (`testing.ADMISSION_SCENARIOS`) on the bf16 model, a QueueFull's
   Retry-After against the seconds its backlog took to drain, and the
   KV-headroom gate under ``TFDE_CAPACITY_BUDGET_BYTES`` of three bf16
   rows (floor one row): each submit rejected exactly when the
   headroom before it is below the floor, int8 KV admitting more rows;
18. decoding — the decoding modes, TF32 off: Llama-3.2-1B at its
   published widths (random weights from seed 0) with `serve_gpt`'s
   quarter-width draft (hidden 512, depth 4, 8 heads of D 64, MLP 2048,
   seed 7): `generate_speculative` in fp32 at num_draft 4, batch 1 x
   128 and 900 prompt tokens and batch 4 x 512, x 32 new (cut from 64
   for the script's time limit), equal to greedy `generate`
   with the small draft and with the target as its own draft (then
   exactly 7 rounds), one prefill of each model's
   flash launches a call, and the sampled rounds (temperature 0.8)
   with the perfect draft at acceptance >= 0.99;
   `SpeculativeContinuousBatcher` (batch 8, max_len 1024) on 12
   requests of 100-900 prompt tokens x 16 (cut from 32), in fp32
   every request equal
   to its solo `generate` and the forward launched 16 + 4 times a
   wave (the counters zeroed just before), in bf16 timed with the small
   and the perfect draft beside the plain ContinuousBatcher (scan depth
   4); beam search (batch 2 x 4 beams, prompt 256, 32 new, length
   penalty 0.6) in fp32, beam 1 equal to greedy `generate`, every beam's
   score within 1e-3 of one cache-free forward of its sequence, sorted
   and distinct, 16 launches (the [8, 256] prefill), and bf16 ms a beam
   step; Gemma-2-2B in fp32 (window 4096, 'alternate') on the rolling
   cache, a 4,352-token prompt x 32 new equal to the full-budget cache's
   tokens, its local planes 4,096 cells and its global 4,384, both
   caches' bytes, 26 launches in the prefill, and the windowed forward
   at [1, 4352, 8 -> 4, 256] (window 4096, cap 50, scale 1/16) against
   its plain version (out and lse) in fp32 and bf16;
19. router — the serving front door (inference/router.py): Llama-3.2-1B
   at its published widths (random weights from seed 0, fp32, one module
   shared by the replicas) behind two in-process ReplicaServers (batch 4,
   max_len 512) and a prefill-role one (batch 1), a Router priming
   prompts of 256 tokens or more. (1) 12 requests of 32-400 prompt
   tokens x 8 new (16 before a slow card host ran the phase in 129.0 s)
   through `request_generate` in parallel threads: every
   token list equal to its solo `generate`, both decode replicas used,
   the long prompts primed and decoded from the hand-off, the flash
   forward launched 16 times a cold wave and a prime and never for a
   primed wave (the counters zeroed just before); TTFT and end-to-end
   seconds, beside the same requests' TTFT in one in-process batcher and
   one request at a time through the router and in-process (the hops'
   cost); (2) replica 0's front door shut: the next 4 requests on replica
   1 with solo tokens, replica 0 down (`router/replicas_lost`,
   `router/replica0/up`, `replica_down` in the flight ring); (3) `python
   -m tfde_tpu_torch.serve_gpt --serve 0` (GPT-2 small, --seed 0) as a
   child beside an in-process replica of the same seeded model (a second
   child prints the weights' sha256, equal to this process's): the
   child's start-up seconds, its request's tokens equal to the
   in-process replica's, then SIGKILL: marked down, the next requests on
   the survivor with equal tokens; (4) a replica capped at one queued
   request answers a burst with 429s (integer Retry-After,
   `QueueFull.as_json()`), and the Router in front of it rejects with 429
   'saturated'; (5) the trace ring on: one long-prompt request's
   stitched waterfall from GET /trace/<id>, its events in causal order
   and their durations; (6) POST /profile {"span": 4}: replica 1
   captures the decode rounds of 4 requests x 16 new on `torch.profiler`
   (CPU and CUDA), the prefill replica refuses with 409 (one window a
   process); the Chrome trace's path and size, its top 5 CUDA kernels,
   the window's device-busy share and an unprofiled tick's; (7) every
   step-loop thread alive, every server closed. Automatic profile
   triggers are off for the phase; the serve_gpt child starts first;
20. moe — Mixture-of-Experts (`models/moe.py`): (a) one MoE layer in
   fp32 on the card against the same weights on the CPU (random weights
   from seed 11): Qwen1.5-MoE-A2.7B's (60 swiglu experts of 1408, top-4,
   raw gates, the shared expert of 5632, the dropless capacity; 2 x 192
   tokens) and gpt_lm --moe 8's at GPT-2 small width (8 gelu + bias
   experts, top-2, capacity 1.25: choices drop; 2 x 256), each through
   both expert-buffer layouts: output, losses and every gradient
   (`MOE_TOL`), the tokens whose routing a near-tie flips counted and
   their groups left out, then the layer in bf16 against itself in fp32
   on one bf16-valued input: output and every gradient (`MOE_BF16_TOL`);
   (b) Qwen1.5-MoE-A2.7B at its published widths
   in fp32, depth cut to 2 (random weights from seed 0): one wave's
   first-token logits flash vs reference (`HF_WAVE_TOL`), then the
   batcher's greedy tokens (6 requests of 16-180 tokens, half after a
   shared 64-token system prompt, x 8) equal to solo `generate` in the
   dense, paged + trie, prefix-cached and int8-KV layouts; (c)
   Qwen1.5-MoE-A2.7B at its published widths and depth (24 layers, bf16
   over fp32 masters cast once, seed 0, built on the card) behind a
   ContinuousBatcher as in the serve phase (batch 8, 16 requests of
   16-960 tokens x 32), the counters zeroed just before: the D-128
   forward once a layer a prefill wave; tokens/s, TTFT, ms a decode
   round, peak memory; one 8-row decode tick's ms beside one MoE layer's
   by CUDA events and by wall clock (the layers' share of a tick) and
   prefill waves of [8, 128], [8, 512] and [8, 1024], each in both
   expert-buffer layouts; then the forward kernel at the prefill shapes
   [1, 4096, 16 -> 16, 128] and [1, 4096, 32 -> 8, 128] against its plain
   version, SDPA and the bound; (d) Mixtral-8x7B-v0.1 at its published
   widths, depth cut to 2: one wave's first-token logits (4 prompts of
   16-960 tokens) flash vs reference in fp32 and bf16 as hf_serve holds
   them, then its artifact written by `save_converted` and served by
   `serve_gpt.main(["--hf-dir", ...])` (16 requests x 8): the D-128
   forward (GQA 32 -> 8) twice a prefill wave; (e) a small fp32 MoE GPT
   (head dim 64, 4 experts in block 1, capacity 1.25, the z-loss on) takes
   one next_token_loss + AdamW step on the card and on the CPU (loss,
   `moe_aux`, `moe_z`, every gradient, the updated parameters; each
   kernel once a layer), then `gpt_lm.main --moe 8` at GPT-2 small
   width (six MoE blocks of 8 experts, capacity 1.25, bf16 over fp32
   masters) for 10 steps of 8 x 1024 tokens, then the same in fp32, the
   counters zeroed just before each: each kernel 12 times a step, every
   loss and `moe_aux` finite, the cross-entropy (the loss less
   `moe_aux`, which grows while the routers learn) falling in both runs
   and the two runs' within `MOE_GL_CE_TOL` step by step, ms a step
   beside the train phase's dense GPT-2 small; the layer's forward and
   backward in both layouts; then 3 bf16 steps profiled. Every artifact lies
   under build/ and is removed at the end.

Every phase prints its seconds.

The last two lines are the kernels JSON line (the three kernels, then
the same three at head dim 256: launches from the Gemma-2-2B serve and
the D-256 training check) and {"ok": true, "device": {...}}. The script imports nothing of JAX.
`--phases kernels,train` (any subset of the phases after the build) runs
only those, prints no result line and exits 1: the parent/change A/B of
kernel and train times.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: H100 SXM data-sheet peaks (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: tolerances of a kernel against its plain version: out relative
#: Frobenius, lse max abs. bf16: the output's rounding to bf16; fp32: the
#: same sums in another order.
TOL = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (1e-5, 1e-5)}
#: tolerance of the backward pair against its plain version, dq, dk and dv
#: each in relative Frobenius. bf16: P and dS are rounded to bf16 before
#: the products (as the TPU kernels do), the plain version keeps them fp32;
#: fp32: the same sums in another order.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
#: clock cycles of the spin kernel ahead of each timed call (~5 ms at the
#: H100's 1.98 GHz boost clock; ~1 ms still let the first timed call of
#: SDPA's backward wait for the host)
SPIN_CYCLES = 10_000_000


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _grads_rel(got: dict, want: dict) -> float:
    """Worst relative Frobenius error over a model's gradients. A gradient
    whose reference norm is below 1e-6 of the global norm is zero in exact
    arithmetic (the key bias: a shift shared by a row's logits leaves the
    softmax unchanged) and rounding noise in both: it must be that small
    on both sides, and is then not compared relatively."""
    total = math.sqrt(sum(float(w.double().norm()) ** 2
                          for w in want.values()))
    worst = 0.0
    for name, w in want.items():
        if float(w.double().norm()) < 1e-6 * total:
            if float(got[name].double().norm()) >= 1e-6 * total:
                return math.inf
            continue
        worst = max(worst, _rel(got[name], w))
    return worst


def _time_ms(fn, dev, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` launches, each after a write
    of 256 MB that evicts the 50 MB L2, timed with CUDA events. A spin
    kernel of ~5 ms runs between the flush and the start event, so the
    host has queued all of `fn` before the card reaches it: the time is
    the card's, not the host's dispatch (autograd's engine thread
    included)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(dev)
    return sum(s.elapsed_time(e) for s, e in events) / iters


def _visible_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps in one [S, S] attention."""
    if not causal:
        return s * s
    if window is None:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def _bound(b, s, h, kv, d, dtype, causal, window, kernel="fwd"):
    """(least ms the H100 needs, 'bytes' | 'operations') for one kernel's
    own work: each input read once and each output written once over HBM
    bandwidth, its products over the peak of the input type.
    fwd: q, k, v in; out, lse out; 2 products (Q K^T, P V), 4*D FLOP a
    visible pair. dkv: q, k, v, dO, lse, delta in; dk, dv out; 4 products
    (K Q^T, V dO^T, P^T dO, dS^T Q), 8*D. dq: the same inputs; dq out; 3
    products (Q K^T, dO V^T, dS K), 6*D."""
    item = torch.tensor([], dtype=dtype).element_size()
    q_elems, kv_elems, rows = b * s * h * d, b * s * kv * d, b * h * s
    nbytes, per_pair = {
        "fwd": ((2 * q_elems + 2 * kv_elems) * item + rows * 4, 4),
        "dkv": ((2 * q_elems + 4 * kv_elems) * item + 2 * rows * 4, 8),
        "dq": ((3 * q_elems + 2 * kv_elems) * item + 2 * rows * 4, 6),
    }[kernel]
    flops = per_pair * d * _visible_pairs(s, causal, window) * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _card() -> str:
    """The first card's `nvidia-smi --query-gpu=name,power.limit` line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    print(_card())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} (devices: "
          f"{torch.cuda.device_count()})")


def phase_build(fa):
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(fa.SOURCES)) as pool:
        libs = dict(zip(fa.SOURCES, pool.map(
            lambda src: fa.build(src, force=True), fa.SOURCES)))
    print(f"build: {len(libs)} sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for src, lib in libs.items():
        print(f"build: {src} -> {os.path.relpath(lib.path)} in "
              f"{lib.seconds:.2f} s")
        for line in lib.log.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line or "arning" in line
                    or "Performance" in line):
                print(f"  ptxas: {line.strip()}")
    _check_sass(fa, libs)
    _print_encode_time(fa)


#: the bf16 kernels, all redesigned for Hopper: each must have compiled to
#: wgmma (HGMMA) and TMA loads (UTMALDG), and to no mma.sync (HMMA)
HOPPER_KERNELS = ("flash_fwd_bf16_kernel", "dkv_bf16_kernel",
                  "dq_bf16_kernel")


def _check_sass(fa, libs):
    """Count HGMMA, UTMALDG and HMMA instructions of each bf16 kernel in
    `cuobjdump -sass` of the built libraries; raise if one lacks wgmma or
    TMA, or still has an mma.sync."""
    from tfde_tpu_torch.utils.build import sass_counts

    seen = set()
    for lib in libs.values():
        for symbol, counts in sass_counts(
                lib.path, ("HGMMA", "UTMALDG", "HMMA", "STL", "LDL")).items():
            name = next((k for k in HOPPER_KERNELS if k in symbol), None)
            if name is None:
                continue
            d = next(d for d in (256, 128, 64) if f"ILi{d}E" in symbol)
            print(f"sass: {name}<{d}>: HGMMA {counts['HGMMA']}, UTMALDG "
                  f"{counts['UTMALDG']}, HMMA {counts['HMMA']}, local-memory "
                  f"STL {counts['STL']} / LDL {counts['LDL']}")
            if not (counts["HGMMA"] and counts["UTMALDG"]) or counts["HMMA"]:
                raise AssertionError(f"{name}<{d}> compiled without wgmma or "
                                     f"TMA, or with mma.sync: {counts}")
            seen.add((name, d))
    want = {(k, d) for k in HOPPER_KERNELS for d in fa.KERNEL_HEAD_DIMS}
    if seen != want:
        raise AssertionError(f"the SASS check found {sorted(seen)}, not "
                             f"{sorted(want)}")


def _print_encode_time(fa):
    """Host time of one TMA tensor-map encode (each bf16 launch of the
    forward encodes 3, of dK/dV and of dQ 4)."""
    base = torch.empty(8 * 1024 * 12 * 64, dtype=torch.bfloat16,
                       device="cuda")
    fn = fa.build("flash_fwd.cu").lib.tfde_flash_tma_encode_ns
    fn(base.data_ptr(), 100)
    ns = fn(base.data_ptr(), 10000)
    print(f"build: one tensor-map encode takes {ns / 1e3:.2f} us on the host "
          f"(mean of 10000; 3 a forward launch, 4 a dK/dV or dQ launch)")


#: (name, B, S, H, KV, D, dtype, causal, window, scale, cap)
CASES = [
    ("slice", 8, 1024, 12, 12, 64, torch.bfloat16, True, None, None, None),
    ("ragged_s200", 2, 200, 12, 12, 64, torch.bfloat16, True, None, None,
     None),
    ("fp32", 2, 256, 4, 4, 64, torch.float32, True, None, None, None),
    ("gqa_window_cap_scale", 2, 384, 8, 2, 64, torch.bfloat16, True, 100,
     0.2, 30.0),
    ("noncausal_d128", 2, 300, 4, 4, 128, torch.bfloat16, False, None,
     None, None),
    ("fp32_gqa_window_cap_d128", 1, 333, 8, 4, 128, torch.float32, True, 70,
     0.1, 20.0),
    # the edges of the 128-row tiles: one row past a tile, the smallest
    # prefill bucket, a window and a ragged edge inside a tile at D 128,
    # and a non-causal ragged edge
    ("s129", 2, 129, 12, 12, 64, torch.bfloat16, True, None, None, None),
    ("s16", 8, 16, 12, 12, 64, torch.bfloat16, True, None, None, None),
    ("gqa_window127_cap_d128", 2, 1000, 8, 2, 128, torch.bfloat16, True, 127,
     None, 30.0),
    ("noncausal_s257", 2, 257, 12, 12, 64, torch.bfloat16, False, None, None,
     None),
    # a window of one key (each row sees only itself) and a query group of
    # three, not a power of two
    ("window1_gqa3", 2, 300, 12, 4, 64, torch.bfloat16, True, 1, None, None),
    # head dims the wrappers zero-pad to 128 (Phi-2's 80, Phi-3's 96 under
    # GQA), and one KV head (multi-query: BigCode, Falcon-7B)
    ("pad_d80", 2, 300, 32, 32, 80, torch.bfloat16, True, None, None, None),
    ("pad_d96_gqa", 2, 257, 32, 8, 96, torch.bfloat16, True, None, None,
     None),
    ("mqa_kv1", 2, 300, 12, 1, 64, torch.bfloat16, True, None, None, None),
    # head dim 256 (Gemma, Gemma-2: query_pre_attn_scalar 256 is the scale
    # 1/16, cap 50; GPT-J, Pythia-1B), where the kernels split their
    # outputs by columns: a window and GQA, a ragged non-causal edge, fp32
    # with a window and cap, and 160 zero-padded to 256
    ("d256_gqa_window_cap", 2, 700, 8, 4, 256, torch.bfloat16, True, 100,
     0.0625, 50.0),
    ("d256_noncausal_s200", 2, 200, 4, 4, 256, torch.bfloat16, False, None,
     None, None),
    ("fp32_d256_gqa_window_cap", 1, 333, 8, 2, 256, torch.float32, True, 70,
     0.0625, 50.0),
    ("pad_d160", 2, 300, 8, 8, 160, torch.bfloat16, True, None, None, None),
]

#: the cases whose backward runs twice and must give the same bits (no
#: atomics, a fixed order of every sum)
DETERMINISM_CASES = ("slice", "gqa_window_cap_scale", "d256_gqa_window_cap")

#: the D 128 timing shape: the slice's model width (768) as 6 heads of 128
D128 = (8, 1024, 6, 6, 128)


def _check_backward(fa, name, q, k, v, causal, window, scale, cap, gen):
    """The backward pair on the card against its plain version on the same
    inputs (the forward kernel's out and lse, one dO): returns the dO, the
    forward's residuals and the max abs error of dq and of dk/dv."""
    dtype = q.dtype
    do = torch.randn(q.shape, generator=gen, device=q.device).to(dtype)
    out, lse = fa.flash_forward(q, k, v, causal, window, scale, cap)
    got = fa.flash_backward(q, k, v, out, lse, do, causal, window, scale,
                            cap)
    torch.cuda.synchronize(q.device)
    want = fa.flash_backward_reference(q, k, v, out, lse, do, causal, window,
                                       scale, cap)
    rels = [_rel(g.float(), w.float()) for g, w in zip(got, want)]
    errs = [float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want)]
    tol = BWD_TOL[dtype]
    # `_grads_rel`: a gradient that is zero in exact arithmetic (dq and dk
    # under a window of one key: P = 1 and dP = delta, so dS = 0) is held
    # to 1e-6 of the plain norms together, not compared relatively
    names = ("dq", "dk", "dv")
    worst = _grads_rel(dict(zip(names, got)), dict(zip(names, want)))
    ok = (all(g.shape == w.shape for g, w in zip(got, want))
          and all(bool(torch.isfinite(g).all()) for g in got)
          and worst <= tol
          and all(float(w.float().abs().max()) > 0 for w in want))
    norms = [float(w.float().norm()) for w in want]
    kernel_norms = [float(g.float().norm()) for g in got]
    print(f"kernel flash_bwd {name}: dq rel {rels[0]:.3e}, dk rel "
          f"{rels[1]:.3e}, dv rel {rels[2]:.3e} (tol {tol:g}; worst "
          f"{worst:.3e} with zero gradients held to 1e-6 of the norm); max "
          f"abs dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}; norms "
          f"plain {norms[0]:.3e}, {norms[1]:.3e}, {norms[2]:.3e}, kernel "
          f"{kernel_norms[0]:.3e}, {kernel_norms[1]:.3e}, "
          f"{kernel_norms[2]:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the flash backward pair disagrees with its "
                             f"plain version on case {name}")
    if name in DETERMINISM_CASES:
        again = fa.flash_backward(q, k, v, out, lse, do, causal, window,
                                  scale, cap)
        same = [bool(torch.equal(a, g)) for a, g in zip(again, got)]
        print(f"kernel flash_bwd {name}: a second call gives the same dq, dk, "
              f"dv bits: {same}")
        if not all(same):
            raise AssertionError(f"the flash backward pair is not "
                                 f"deterministic on case {name}: {same}")
    return do, out, lse, errs[0], max(errs[1], errs[2])


def _time_backward(fa, q, k, v, do, out, lse, causal, dev, result):
    """Times of the backward pair at the slice shape: each kernel alone,
    the plain backward, the pair's total (delta + dkv + dq) and SDPA's
    backward alone (autograd.grad on a kept SDPA graph; timing only)."""
    import torch.nn.functional as F

    b, s, h, d = q.shape
    delta = fa._delta(out, do)
    dkv, dq = result["flash_bwd_dkv"], result["flash_bwd_dq"]
    dkv["ms"] = _time_ms(
        lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal), dev)
    dq["ms"] = _time_ms(
        lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal), dev)
    plain = _time_ms(lambda: fa.flash_backward_reference(
        q, k, v, out, lse, do, causal), dev, iters=5)
    pair = _time_ms(
        lambda: fa.flash_backward(q, k, v, out, lse, do, causal), dev)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ref = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    library = _time_ms(lambda: torch.autograd.grad(
        ref, (qt, kt, vt), dot, retain_graph=True), dev)
    for entry, kernel in ((dkv, "dkv"), (dq, "dq")):
        entry["plain_ms"] = plain
        entry["library_ms"] = library
        entry["bound_ms"], entry["bound_by"] = _bound(
            b, s, h, k.shape[2], d, q.dtype, causal, None, kernel)
    print(f"kernel flash_bwd slice timing: dkv_ms {dkv['ms']:.4f} (bound "
          f"{dkv['bound_ms']:.4f}, {dkv['bound_by']}), dq_ms "
          f"{dq['ms']:.4f} (bound {dq['bound_ms']:.4f}, {dq['bound_by']}), "
          f"pair total (delta + dkv + dq) {pair:.4f}, plain_ms {plain:.4f}, "
          f"library_ms (SDPA backward alone) {library:.4f}")
    return pair


def phase_kernels(fa, dev):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(1)
    result = {"flash_fwd": {}, "flash_bwd_dkv": {}, "flash_bwd_dq": {}}
    fwd = result["flash_fwd"]
    for name, b, s, h, kv, d, dtype, causal, window, scale, cap in CASES:
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
        out, lse = fa.flash_forward(q, k, v, causal, window, scale, cap)
        torch.cuda.synchronize(dev)
        ref_out, ref_lse = fa.flash_forward_reference(q, k, v, causal,
                                                      window, scale, cap)
        out_rel = _rel(out.float(), ref_out.float())
        lse_err = float((lse - ref_lse).abs().max())
        max_abs = float((out.float() - ref_out.float()).abs().max())
        tol_out, tol_lse = TOL[dtype]
        ok = (out.shape == ref_out.shape and lse.shape == ref_lse.shape
              and bool(torch.isfinite(out).all())
              and out_rel <= tol_out and lse_err <= tol_lse)
        print(f"kernel flash_fwd {name}: B={b} S={s} H={h} KV={kv} D={d} "
              f"{str(dtype).split('.')[-1]} causal={causal} window={window} "
              f"scale={scale} cap={cap}: out rel {out_rel:.3e} (tol "
              f"{tol_out:g}), lse max abs {lse_err:.3e} (tol {tol_lse:g}), "
              f"out max abs {max_abs:.3e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain "
                                 f"version on case {name}")
        do, out, lse, dq_err, dkv_err = _check_backward(
            fa, name, q, k, v, causal, window, scale, cap, gen)
        if name == "slice":
            fwd["max_abs_err"] = max_abs
            result["flash_bwd_dq"]["max_abs_err"] = dq_err
            result["flash_bwd_dkv"]["max_abs_err"] = dkv_err
            fwd["ms"] = _time_ms(
                lambda: fa.flash_forward(q, k, v, causal), dev)
            fwd["plain_ms"] = _time_ms(
                lambda: fa.flash_forward_reference(q, k, v, causal), dev,
                iters=5)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            fwd["library_ms"] = _time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True), dev)
            fwd["bound_ms"], fwd["bound_by"] = _bound(
                b, s, h, kv, d, dtype, causal, window)
            print(f"kernel flash_fwd slice timing: kernel_ms "
                  f"{fwd['ms']:.4f}, plain_ms {fwd['plain_ms']:.4f}, "
                  f"library_ms (SDPA) {fwd['library_ms']:.4f}, bound_ms "
                  f"{fwd['bound_ms']:.4f} ({fwd['bound_by']})")
            _time_backward(fa, q, k, v, do, out, lse, causal, dev, result)
    _time_d128(fa, dev, gen)
    result.update(_kernels_d256(fa, dev))
    return result


#: head dim 256 at Gemma-2-2B's shapes ([B, S, H, D] queries and KV
#: heads): the prefill forward of a 4096-token prompt and the backward pair
#: of 2 x 1024 training tokens, both causal with the model's logit cap 50
#: and scale 1/16 (query_pre_attn_scalar 256); the prefill with the local
#: layers' window 4096, which at S = 4096 is the causal band
D256_PREFILL, D256_TRAIN, D256_OPTS = ((1, 4096, 8, 256), 4), \
    ((2, 1024, 8, 256), 4), dict(causal=True, scale=1 / 16, cap=50.0)


def _kernels_d256(fa, dev):
    """The three bf16 kernels at head dim 256 (`_kernels_at`): the forward
    at Gemma-2-2B's prefill shape, the backward pair at its training
    shape. Returns their entries of the kernels JSON line."""
    fwd = _kernels_at(fa, dev, "d256 prefill", D256_PREFILL[0],
                      kv=D256_PREFILL[1], window=4096, backward=False,
                      **D256_OPTS)
    bwd = _kernels_at(fa, dev, "d256 train", D256_TRAIN[0],
                      kv=D256_TRAIN[1], **D256_OPTS)
    return {"flash_fwd_d256": fwd["flash_fwd"],
            "flash_bwd_dkv_d256": bwd["flash_bwd_dkv"],
            "flash_bwd_dq_d256": bwd["flash_bwd_dq"]}


def _time_d128(fa, dev, gen):
    """The three bf16 kernels at D 128 (8 x 1024 tokens, 6 heads, bf16,
    causal) beside their bounds and SDPA's forward / backward."""
    import torch.nn.functional as F

    b, s, h, kv, d = D128
    q, k, v, do = (torch.randn((b, s, n, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (h, kv, kv, h))
    out, lse = fa.flash_forward(q, k, v, True)
    delta = fa._delta(out, do)
    fwd_ms = _time_ms(lambda: fa.flash_forward(q, k, v, True), dev)
    dkv_ms = _time_ms(
        lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True), dev)
    dq_ms = _time_ms(
        lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True), dev)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), dev)
    ref = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    sdpa_bwd = _time_ms(lambda: torch.autograd.grad(
        ref, (qt, kt, vt), dot, retain_graph=True), dev)
    fb, fby = _bound(b, s, h, kv, d, torch.bfloat16, True, None)
    db, dby = _bound(b, s, h, kv, d, torch.bfloat16, True, None, "dkv")
    qb, qby = _bound(b, s, h, kv, d, torch.bfloat16, True, None, "dq")
    print(f"kernel D128 timing ({b} x {s}, {h} heads, D {d}, bf16, causal): "
          f"flash_fwd {fwd_ms:.4f} ms (bound {fb:.4f}, {fby}; SDPA forward "
          f"{sdpa_fwd:.4f}), flash_bwd_dkv {dkv_ms:.4f} ms (bound {db:.4f}, "
          f"{dby}), flash_bwd_dq {dq_ms:.4f} ms (bound {qb:.4f}, {qby}); "
          f"SDPA backward, whole {sdpa_bwd:.4f}")


def phase_parity(dev):
    from tfde_tpu_torch.inference.decode import generate, init_cache
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.models.gpt import GPT
    from tfde_tpu_torch.ops import flash_attention as fa

    cfg = dict(vocab_size=97, hidden_size=128, depth=2, num_heads=2,
               mlp_dim=256, max_position=64, dtype=torch.float32, seed=3)
    gpu = GPT(device=dev, **cfg)
    cpu = GPT(device="cpu", **cfg)
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 97, (3, 40))
    before = fa.flash_forward.launches
    with torch.no_grad():
        got = gpu(torch.as_tensor(ids, device=dev),
                  cache=init_cache(gpu, 3, 48))
        want = cpu(torch.as_tensor(ids), cache=init_cache(cpu, 3, 48))
    rel = _rel(got.cpu(), want)
    if fa.flash_forward.launches - before != cfg["depth"]:
        raise AssertionError("the CUDA prefill did not run the flash kernel")
    print(f"parity: fp32 GPT(D=64) prefill logits, CUDA flash vs CPU plain: "
          f"rel {rel:.3e} (tol 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError("CUDA prefill logits disagree with the CPU")
    srv = ContinuousBatcher(gpu, batch_size=2, max_len=48, scan_depth=4,
                            device=dev)
    prompts = [rng.integers(0, 97, p) for p in (5, 11, 3, 8)]
    rids = [srv.submit(p, 10) for p in prompts]
    done = dict(srv.run())
    same = 0
    for rid, p in zip(rids, prompts):
        toks, lens = generate(cpu, p[None, :], 10, device="cpu")
        same += int(np.array_equal(done[rid],
                                   toks[0, p.size:int(lens[0])].numpy()))
    print(f"parity: CUDA batcher greedy tokens == CPU generate for "
          f"{same}/{len(prompts)} requests")
    if same != len(prompts):
        raise AssertionError("CUDA batcher tokens differ from CPU generate")


def phase_serve(fa, dev):
    from tfde_tpu_torch.inference.decode import init_cache
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.models.gpt import GPT2Small

    model = GPT2Small(vocab_size=50257, max_position=1024,
                      dtype=torch.bfloat16, device=dev,
                      seed=0).cast_compute_weights_()
    srv = ContinuousBatcher(model, batch_size=8, max_len=1024,
                            scan_depth=4, device=dev)
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 961, 16)
    prompts = [rng.integers(0, model.vocab_size, int(p)) for p in plens]
    torch.cuda.synchronize(dev)
    fa.flash_forward.launches = 0
    t0 = time.perf_counter()
    rids = [srv.submit(p, 32) for p in prompts]
    done = dict(srv.run())
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = fa.flash_forward.launches
    stats = srv.stats()
    ttft = srv.ttft_ms()
    n_tok = sum(len(t) for t in done.values())
    print(f"serve: GPT-2 small bf16, batch 8, max_len 1024, scan depth 4: "
          f"{len(done)}/16 requests, {n_tok} tokens in {dt:.3f} s "
          f"({n_tok / dt:.1f} tok/s), mean TTFT "
          f"{sum(ttft.values()) / max(len(ttft), 1):.1f} ms")
    print(f"serve: prompt lengths {[int(p) for p in plens]}")
    print(f"serve: stats {json.dumps(stats)}")
    print(f"serve: flash_fwd launches {launches} over "
          f"{stats['prefill_waves']} prefill waves x {model.depth} layers")
    if sorted(done) != sorted(rids):
        raise AssertionError("not every request finished")
    for rid, toks in done.items():
        if len(toks) != 32 or toks.min() < 0 or toks.max() >= 50257:
            raise AssertionError(f"request {rid} returned {toks!r}")
    if not (launches > 0 and launches == model.depth * stats["prefill_waves"]):
        raise AssertionError("the serve path did not run the flash kernel "
                             "once per layer per prefill wave")

    # one wave's first-token logits, flash vs the reference einsum
    wave = prompts[:4]
    bucket = 1 << max(3, math.ceil(math.log2(max(p.size for p in wave))))
    batch = np.zeros((len(wave), bucket), np.int64)
    for i, p in enumerate(wave):
        batch[i, :p.size] = p
    last = torch.as_tensor([p.size - 1 for p in wave], device=dev)
    rows = torch.arange(len(wave), device=dev)
    logits = {}
    with torch.no_grad():
        for impl in ("flash", "reference"):
            model.set_attn_impl(impl)
            h = model.hidden(torch.as_tensor(batch, device=dev),
                             cache=init_cache(model, len(wave), bucket))
            logits[impl] = model.head(h[rows, last])
    model.set_attn_impl("auto")
    rel = _rel(logits["flash"], logits["reference"])
    finite = bool(torch.isfinite(logits["flash"]).all())
    print(f"serve: first-token logits of a {len(wave)} x {bucket} wave, "
          f"flash vs reference: rel {rel:.3e} (tol 2e-2), finite {finite}")
    if not (finite and rel <= 2e-2):
        raise AssertionError("flash and reference prefill logits disagree")
    return launches


def phase_train_parity(fa, dev):
    from tfde_tpu_torch.models.gpt import GPT, next_token_loss
    from tfde_tpu_torch.training.optimizers import adamw
    from tfde_tpu_torch.training.step import init_state

    cfg = dict(vocab_size=97, hidden_size=128, depth=2, num_heads=2,
               mlp_dim=256, max_position=64, dtype=torch.float32, seed=3)
    models = {"cuda": GPT(device=dev, **cfg), "cpu": GPT(device="cpu", **cfg)}
    models["cpu"].load_state_dict(
        {k: t.cpu() for k, t in models["cuda"].state_dict().items()})
    ids = np.random.default_rng(4).integers(0, 97, (4, 40))
    torch.cuda.synchronize(dev)
    before = (fa.flash_forward.launches, fa.flash_backward.dkv_launches,
              fa.flash_backward.dq_launches)
    got = {}
    for where, model in models.items():
        state = init_state(model, adamw(model, 1e-3, weight_decay=0.1))
        loss, _ = next_token_loss(model, torch.as_tensor(ids,
                                                         device=model.device))
        loss.backward()
        grads = {n: p.grad.cpu().clone() for n, p in
                 model.named_parameters()}
        state.apply_gradients()
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        got[where] = (float(loss.detach()), grads, params)
    launched = [after - b for after, b in zip(
        (fa.flash_forward.launches, fa.flash_backward.dkv_launches,
         fa.flash_backward.dq_launches), before)]
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = got["cuda"], got["cpu"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = _grads_rel(g_gpu, g_cpu)
    # the updated parameters as one vector: Adam turns the key bias's
    # rounding-noise gradient into a step of ~lr * 1e-2 whose sign is the
    # noise's, so that parameter alone is not comparable relatively
    param_rel = _rel(torch.cat([p_gpu[n].flatten() for n in p_cpu]),
                     torch.cat([p.flatten() for p in p_cpu.values()]))
    print(f"train parity: fp32 GPT(D=64) one next_token_loss + AdamW step, "
          f"CUDA kernels vs CPU plain: loss {l_gpu:.6f} vs {l_cpu:.6f} (rel "
          f"{loss_rel:.3e}, tol 1e-5), worst gradient rel {grad_rel:.3e} "
          f"(tol 1e-4; zero gradients held to 1e-6 of the norm), updated "
          f"params rel {param_rel:.3e} (tol 1e-4); launches fwd/dkv/dq "
          f"{launched}")
    if launched != [cfg["depth"]] * 3:
        raise AssertionError("the CUDA train step did not run each flash "
                             "kernel once per layer")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and param_rel <= 1e-4):
        raise AssertionError("the CUDA train step disagrees with the CPU")
    return _train_parity_d256(fa, dev)


#: the D-256 training check: a 2-layer Gemma-2-shaped GPT (head dim 256
#: beside hidden 256, 4 -> 2 KV heads, rope, RMSNorm, geglu, the cap 50
#: and scale 1/16, the window 24 on even layers), D256_STEPS AdamW steps
#: of 4 x 96 tokens
D256_GPT = dict(vocab_size=97, hidden_size=256, depth=2, num_heads=4,
                num_kv_heads=2, head_dim=256, mlp_dim=512, max_position=128,
                position="rope", norm="rms", mlp_act="geglu", use_bias=False,
                attn_scale=1 / 16, attn_logit_cap=50.0, sliding_window=24,
                sliding_window_pattern="alternate", seed=3)
D256_STEPS = 3


def _train_parity_d256(fa, dev):
    """D256_STEPS next_token_loss + AdamW steps of a GPT with head dim
    256 on the card (the D-256 forward and backward kernels inside
    autograd) against the same steps on the CPU, fp32: every step's loss
    and the final parameters; then the same steps in bf16 compute on the
    card (the bf16 D-256 kernels), losses finite and near fp32's. The
    counters are zeroed just before and read just after: one launch of
    each kernel a layer a step. Returns the D-256 launches by kernel."""
    from tfde_tpu_torch.models.gpt import GPT, next_token_loss
    from tfde_tpu_torch.training.optimizers import adamw
    from tfde_tpu_torch.training.step import init_state, make_custom_train_step

    ids = np.random.default_rng(9).integers(0, 97, (D256_STEPS, 4, 96))
    runs = {}
    torch.cuda.synchronize(dev)
    _zero_counts(fa)
    weights = None
    for where, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                         ("cuda bf16", torch.bfloat16)):
        device = dev if where.startswith("cuda") else "cpu"
        model = GPT(device=device, dtype=dtype, **D256_GPT)
        if weights is None:  # the card's initial weights on every side
            weights = {k: t.detach().cpu().clone()
                       for k, t in model.state_dict().items()}
        model.load_state_dict(weights)
        state = init_state(model, adamw(model, 1e-3, weight_decay=0.1))
        step_fn = make_custom_train_step(next_token_loss)
        losses = []
        for x in ids:
            state, metrics = step_fn(state, (torch.as_tensor(x,
                                                             device=device),))
            losses.append(float(metrics["loss"]))
        params = torch.cat([p.detach().cpu().flatten()
                            for p in model.parameters()])
        runs[where] = (losses, params)
    torch.cuda.synchronize(dev)
    launched = {"fwd": fa.flash_forward.by_head_dim[256],
                "dkv": fa.flash_backward.dkv_by_head_dim[256],
                "dq": fa.flash_backward.dq_by_head_dim[256]}
    (l_gpu, p_gpu), (l_cpu, p_cpu), (l_bf16, _) = runs.values()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    param_rel = _rel(p_gpu, p_cpu)
    bf16_rel = max(abs(a - b) / abs(b) for a, b in zip(l_bf16, l_gpu))
    want = 2 * D256_GPT["depth"] * D256_STEPS
    print(f"train parity d256: a GPT with head dim 256 (4 -> 2 KV heads, "
          f"cap 50, window 24), {D256_STEPS} AdamW steps of 4 x 96 tokens, "
          f"CUDA kernels vs CPU plain, fp32: losses {l_gpu} vs {l_cpu} "
          f"(worst rel {loss_rel:.3e}, tol 1e-5), final params rel "
          f"{param_rel:.3e} (tol 1e-4); bf16 compute on the card: losses "
          f"{l_bf16} (worst rel to fp32 {bf16_rel:.3e}, tol 2e-2); D-256 "
          f"launches {launched} (fp32 and bf16 runs)")
    if set(launched.values()) != {want}:
        raise AssertionError(f"the D-256 train steps did not launch each "
                             f"kernel once a layer a step: {launched}")
    if not (loss_rel <= 1e-5 and param_rel <= 1e-4 and bf16_rel <= 2e-2
            and all(math.isfinite(x) for x in l_bf16)):
        raise AssertionError("the D-256 train steps disagree with the CPU")
    return launched


#: kernel-name fragments (lower case) of each group in the train step's
#: profile; the first group that matches takes the kernel
KERNEL_GROUPS = (
    ("flash_fwd", ("flash_fwd",)),
    ("flash_bwd", ("dkv_", "dq_")),
    ("matmul", ("gemm", "sm90", "cutlass", "nvjet", "xmma")),
    ("optimizer", ("multi_tensor_apply",)),
    ("softmax_ce", ("softmax", "nll")),
    ("casts_copies", ("copy_kernel",)),
)


def _profile_train(run, batches, dev, step_ms, label="train"):
    """Profile a few more train steps (`run(batch)` -> the step's loss
    tensor) with torch.profiler and print them (`_print_profile`)."""
    from tfde_tpu_torch.testing import profile_steps

    _print_profile(profile_steps(run, batches, dev), len(batches), step_ms,
                   label)


def _print_profile(prof, n, step_ms, label):
    """Device time a step by kernel group and the top kernels; the device's
    idle share, 1 - busy / `step_ms` (the unprofiled step time: the
    profiler slows the host); the top host operators by self time (the
    profiler inflates them; their order says where the host spends the
    step)."""
    kernels = prof["device"]
    if not kernels:
        print(f"{label} profile: the profiler recorded no device time; busy "
              "share not measured")
        return
    busy = sum(ms for _, ms in kernels)
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, ms in kernels:
        name = next((g for g, frags in KERNEL_GROUPS
                     if any(f in key.lower() for f in frags)), "other")
        groups[name] += ms
    print(f"{label} profile ({n} steps, torch.profiler): device busy "
          f"{busy:.2f} ms a step; idle share {1 - busy / step_ms:.3f} of the "
          f"unprofiled {step_ms:.2f} ms step (profiled wall "
          f"{prof['wall_ms']:.2f} ms)")
    print(f"{label} profile: device ms a step by group "
          + json.dumps({k: round(v, 3) for k, v in groups.items()}))
    for key, ms in sorted(kernels, key=lambda kv: -kv[1])[:10]:
        print(f"{label} profile:   {ms:8.3f} ms  {key[:110]}")
    for key, ms, calls in sorted(prof["host"], key=lambda kv: -kv[1])[:6]:
        print(f"{label} profile: host {ms:8.3f} ms a step, {calls} calls  "
              f"{key[:80]}")


def phase_train(fa, dev):
    from tfde_tpu_torch.data.datasets import synthetic_tokens
    from tfde_tpu_torch.models.gpt import GPT2Small, next_token_loss
    from tfde_tpu_torch.training.optimizers import (
        adamw, warmup_cosine_decay_schedule)
    from tfde_tpu_torch.training.step import init_state, make_custom_train_step

    steps, batch, seq, profiled = 20, 8, 1024, 3
    model = GPT2Small(vocab_size=50257, max_position=1024,
                      dtype=torch.bfloat16, device=dev, seed=0)
    tokens = synthetic_tokens(256, seq, vocab=model.vocab_size, seed=2)
    state = init_state(model, adamw(
        model, warmup_cosine_decay_schedule(0.0, 3e-4, 5, steps),
        weight_decay=0.1))
    step_fn = make_custom_train_step(next_token_loss, grad_accum=1)
    nrng = np.random.default_rng(0)
    batches = [torch.as_tensor(tokens[nrng.integers(0, len(tokens), batch)],
                               device=dev) for _ in range(steps + profiled)]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_forward.launches = 0
    fa.flash_backward.dkv_launches = 0
    fa.flash_backward.dq_launches = 0
    losses, clock = [], [time.perf_counter()]
    for x in batches[:steps]:
        state, metrics = step_fn(state, (x,))
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize(dev)
        clock.append(time.perf_counter())
    launches = {"flash_fwd": fa.flash_forward.launches,
                "flash_bwd_dkv": fa.flash_backward.dkv_launches,
                "flash_bwd_dq": fa.flash_backward.dq_launches}
    step_s = [b - a for a, b in zip(clock, clock[1:])]
    mean_s = sum(step_s[2:]) / len(step_s[2:])
    print(f"train: GPT-2 small, fp32 master weights, bf16 compute, batch "
          f"{batch} x {seq} tokens, AdamW lr 3e-4 warmup 5 cosine {steps}, "
          f"wd 0.1: {steps} steps")
    print(f"train: losses {[round(x, 4) for x in losses]}")
    print(f"train: losses, full precision (identical run to run: no atomics) "
          f"{losses}")
    print(f"train: ms per step (mean of steps 3-{steps}) {mean_s * 1e3:.2f}, "
          f"first step {step_s[0] * 1e3:.1f} ms, {batch * seq / mean_s:.0f} "
          f"training tokens/s, max memory allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    print(f"train: launches {json.dumps(launches)} over {steps} steps x "
          f"{model.depth} layers")
    if any(n != model.depth * steps for n in launches.values()):
        raise AssertionError("the train path did not run each flash kernel "
                             "once per layer per step")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    _profile_train(lambda x: step_fn(state, (x,))[1]["loss"],
                   batches[steps:], dev, mean_s * 1e3)
    return launches


#: dp parity: the CUDA run (DDP on a one-rank NCCL group, cuDNN, fp32 with
#: TF32 off) against the CPU run on the same weights and batches, five
#: sgd(0.05) steps of BatchNormCNN. With cuDNN's default algorithms (those
#: the recipe runs): the losses' max relative error, the final parameters
#: and running statistics as one vector (relative Frobenius error) and
#: their max abs error. Not tensor by tensor: the first BatchNorm's bias
#: (~2e-2) has a gradient that nearly cancels (the next BatchNorm removes
#: a shift of its input), and the default convolution backward
#: algorithms, whose bits change run to run, leave it ~4e-4 of itself from
#: an fp64 run in most runs, where the CPU and cuDNN's deterministic
#: algorithms leave it ~5e-7. Under `cudnn.deterministic` every tensor is held relatively
#: (`tensor_rel`), and so is every tensor of the same runs in fp64
#: (`fp64_rel`), where rounding is ~1e-16.
DP_TOL = {"loss": 1e-5, "params_rel": 1e-5, "params_abs": 1e-4,
          "tensor_rel": 1e-4, "fp64_rel": 1e-9}
#: dp training: the reference recipe (global batch 128, sgd(0.2, momentum
#: 0.9), dropout 0.5), timed over steps 10-100; the eval at step 100 is
#: printed only: the running statistics (momentum 0.99) still hold 0.99^100
#: = 37% of their initial values there, and the JAX package's own run of the
#: recipe evaluates at 0.44 (CPU). The accuracy is asserted after DP_STEPS.
DP_BATCH, DP_TIMED, DP_STEPS, DP_EVAL_BATCH = 128, (10, 100), 300, 768
#: dp: steps profiled after the run (torch.profiler), for the idle share
DP_PROFILED = 20


def _dp_eval(strategy, state, images, labels):
    """(accuracy, mean loss, weight) of a whole-set pass of `make_eval_step`
    in batches of DP_EVAL_BATCH, each padded by `pad_batch_for_mesh` to
    that size: the last (10000 = 13 x 768 + 16) is ragged on purpose."""
    from tfde_tpu_torch.training.step import make_eval_step, pad_batch_for_mesh

    if DP_EVAL_BATCH % strategy.batch_divisor:
        raise AssertionError("the eval batch does not divide by the mesh")
    step = make_eval_step(strategy, state)
    sums = {"loss_sum": 0.0, "correct_sum": 0.0, "weight": 0.0}
    for i in range(0, len(images), DP_EVAL_BATCH):
        batch = pad_batch_for_mesh((images[i:i + DP_EVAL_BATCH],
                                    labels[i:i + DP_EVAL_BATCH]),
                                   DP_EVAL_BATCH)
        for k, v in step(state, batch).items():
            sums[k] += float(v)
    w = sums["weight"]
    return sums["correct_sum"] / w, sums["loss_sum"] / w, w


def _dp_parity(dev, images, labels):
    """BatchNormCNN, five sgd(0.05) steps on the same weights and batches:
    DDP on the one-rank NCCL group (CUDA) against no group (CPU), in fp32
    (with cuDNN's default algorithms three times, under
    `cudnn.deterministic` twice) and in fp64, held to DP_TOL; printed too:
    whether the repeated card runs give the same bits, and how far each
    fp32 run lies from the CPU's fp64 run. Returns the CPU fp32 run, for
    `_dp_cards`."""
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.runtime.mesh import LocalMesh
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state, make_train_step

    batches = [(images[i * 64:(i + 1) * 64], labels[i * 64:(i + 1) * 64])
               for i in range(5)]
    initial = BatchNormCNN(dropout_rate=0.0, device="cpu", seed=0).state_dict()
    cuda_strategy = MultiWorkerMirroredStrategy()
    if torch.distributed.get_backend(cuda_strategy.data_group) != "nccl":
        raise AssertionError("the CUDA run is not on the NCCL group")
    cpu_strategy = MultiWorkerMirroredStrategy(mesh=LocalMesh(("data",)))

    def run(device, dtype, strategy, deterministic=False):
        model = BatchNormCNN(dropout_rate=0.0, device=device, seed=0)
        model.load_state_dict(initial)
        model.to(dtype)
        state = init_state(model, sgd(model, 0.05))
        step = make_train_step(strategy, state)
        torch.backends.cudnn.deterministic = deterministic
        try:
            losses = [float(step(state, b)[1]["loss"]) for b in batches]
        finally:
            torch.backends.cudnn.deterministic = False
        return losses, {k: v.detach().cpu() for k, v in
                        model.state_dict().items()}

    l_cpu, p_cpu = run("cpu", torch.float32, cpu_strategy)
    l_64, p_64 = run("cpu", torch.float64, cpu_strategy)
    default = [run(dev, torch.float32, cuda_strategy) for _ in range(3)]
    determ = [run(dev, torch.float32, cuda_strategy, True) for _ in range(2)]
    l_cuda64, p_cuda64 = run(dev, torch.float64, cuda_strategy)

    def worst(params, ref):
        errs = {k: _rel(params[k], v) for k, v in ref.items()}
        k = max(errs, key=errs.get)
        return f"{errs[k]:.3e} ({k})", errs[k]

    def same(runs):
        return all(all(torch.equal(p[k], v) for k, v in runs[0][1].items())
                   for _, p in runs[1:])

    def loss_rel(losses, ref):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, ref))

    what = (f"{cuda_strategy.describe()} as DDP on NCCL (CUDA) vs no group "
            f"(CPU)")
    _dp_compare(what, *default[0], l_cpu, p_cpu)
    det_loss = loss_rel(determ[0][0], l_cpu)
    det_text, det_err = worst(determ[0][1], p_cpu)
    print(f"dp parity, run to run on the card (fp32): same bits in 3 runs "
          f"with cuDNN's default algorithms: {same(default)}, in 2 with "
          f"cudnn.deterministic: {same(determ)}; worst single tensor rel vs "
          f"the CPU's fp32 run: default "
          f"{[worst(p, p_cpu)[0] for _, p in default]}, deterministic "
          f"{[worst(p, p_cpu)[0] for _, p in determ]} (tol "
          f"{DP_TOL['tensor_rel']:g}; losses max rel {det_loss:.3e})")
    if not (det_err <= DP_TOL["tensor_rel"] and det_loss <= DP_TOL["loss"]):
        raise AssertionError(f"the fp32 run under cudnn.deterministic "
                             f"({what}) disagrees with the CPU run: "
                             f"{det_text}")
    print(f"dp parity, distance from the CPU's fp64 run (worst single tensor "
          f"rel): CPU fp32 {worst(p_cpu, p_64)[0]}; card fp32 default "
          f"{[worst(p, p_64)[0] for _, p in default]}, deterministic "
          f"{[worst(p, p_64)[0] for _, p in determ]}")
    loss64 = loss_rel(l_cuda64, l_64)
    text, err64 = worst(p_cuda64, p_64)
    print(f"dp parity fp64: {what}: losses max rel {loss64:.3e}, worst single "
          f"tensor rel {text} (tol {DP_TOL['fp64_rel']:g})")
    if not (loss64 <= DP_TOL["fp64_rel"] and err64 <= DP_TOL["fp64_rel"]):
        raise AssertionError(f"the fp64 data-parallel run ({what}) disagrees "
                             f"with the CPU run")
    return ({k: v.numpy() for k, v in initial.items()}, batches, l_cpu,
            p_cpu)


def _dp_compare(what, losses, params, l_cpu, p_cpu):
    """Hold a run's losses and final parameters and statistics to the CPU
    run's under DP_TOL; print the errors."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, l_cpu))
    vec_rel = _rel(torch.cat([params[k].flatten() for k in p_cpu]),
                   torch.cat([v.flatten() for v in p_cpu.values()]))
    abs_err = {k: float((params[k] - v).abs().max()) for k, v in p_cpu.items()}
    worst = max(abs_err, key=abs_err.get)
    print(f"dp parity: BatchNormCNN, 5 sgd(0.05) steps of 64, fp32, {what}: "
          f"losses {[round(x, 6) for x in losses]} vs "
          f"{[round(x, 6) for x in l_cpu]}, max rel {loss_rel:.3e} (tol "
          f"{DP_TOL['loss']:g}); parameters and statistics as one vector rel "
          f"{vec_rel:.3e} (tol {DP_TOL['params_rel']:g}), max abs "
          f"{abs_err[worst]:.3e} ({worst}; tol {DP_TOL['params_abs']:g}); "
          f"worst single-tensor rel "
          f"{max(_rel(params[k], v) for k, v in p_cpu.items()):.3e}")
    if not (loss_rel <= DP_TOL["loss"] and vec_rel <= DP_TOL["params_rel"]
            and abs_err[worst] <= DP_TOL["params_abs"]):
        raise AssertionError(f"the data-parallel run ({what}) disagrees with "
                             f"the CPU run")


def _dp_train(dev, train, test):
    from tfde_tpu_torch.mnist_multiworker import global_batches
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state, make_train_step

    model = BatchNormCNN(device=dev, seed=0)
    state = init_state(model, sgd(model, 0.2, momentum=0.9))
    strategy = MultiWorkerMirroredStrategy()
    step = make_train_step(strategy, state)
    generator = torch.Generator(device=dev).manual_seed(0)
    batches = list(global_batches(*train, DP_BATCH, DP_STEPS))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, clock = [], {}
    for i, batch in enumerate(batches):
        if i in DP_TIMED:
            torch.cuda.synchronize(dev)
            clock[i] = time.perf_counter()
        if i == DP_TIMED[1]:
            acc100, loss100, _ = _dp_eval(strategy, state, *test)
        state, metrics = step(state, batch, generator)
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    ms = (clock[DP_TIMED[1]] - clock[DP_TIMED[0]]) * 1e3 / (
        DP_TIMED[1] - DP_TIMED[0])
    acc, eval_loss, weight = _dp_eval(strategy, state, *test)
    _profile_train(lambda b: step(state, b, generator)[1]["loss"],
                   batches[:DP_PROFILED], dev, ms, label="dp")
    print(f"dp train: BatchNormCNN (dropout 0.5), {strategy.describe()} as "
          f"DDP on NCCL, global batch {DP_BATCH}, sgd(0.2, momentum=0.9), "
          f"{DP_STEPS} steps; losses at steps 1, 10, 100, {DP_STEPS}: "
          f"{losses[0]:.4f}, {losses[9]:.4f}, {losses[99]:.4f}, "
          f"{losses[-1]:.4f}")
    print(f"dp train: {ms:.3f} ms per step (mean of steps "
          f"{DP_TIMED[0] + 1}-{DP_TIMED[1]}, host clock after a synchronise), "
          f"{DP_BATCH / ms * 1e3:.0f} images/s, max memory allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 20:.1f} MiB, on "
          f"{_card()}")
    print(f"dp eval: {int(weight)} test images in batches of "
          f"{DP_EVAL_BATCH} (the last padded from {len(test[0]) % DP_EVAL_BATCH}"
          f" and masked): accuracy {acc:.4f} (>= 0.95), loss {eval_loss:.4f}; "
          f"at step 100 (printed only): accuracy {acc100:.4f}, loss "
          f"{loss100:.4f}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < 0.1:
        raise AssertionError(f"the loss ends at {losses[-1]}, not below 0.1")
    if weight != len(test[0]) or not acc >= 0.95:
        raise AssertionError(f"eval over {weight} images: accuracy {acc}")
    return ms


def _dp_cards(parity_ref):
    """Across every card of the machine, one process a card on an NCCL
    group (`testing.dp_ranks_worker`): the parity run split over the cards
    against the CPU run, the same bits on every rank, and the recipe at
    DP_BATCH a card, timed over steps 11-100 (the slowest rank's clock),
    with its scaling efficiency against the same worker run as one rank on
    one card just before (the same process setup on both sides)."""
    from tfde_tpu_torch.testing import dp_ranks_worker, run_ranks

    n = torch.cuda.device_count()
    if n < 2:
        print(f"dp cards: {n} card on this machine; the run across cards "
              f"needs two or more (not run)")
        return
    initial, batches, l_cpu, p_cpu = parity_ref

    def ranks(world, profiled):
        store = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", f"dp_store_{os.getpid()}_{world}")
        os.makedirs(os.path.dirname(store), exist_ok=True)
        try:
            return run_ranks(dp_ranks_worker, [
                (world, store, "cuda", ("BatchNormCNN", initial, batches,
                                        0.05),
                 DP_BATCH, DP_TIMED[1], DP_TIMED[0], profiled)] * world,
                timeout=600)
        finally:
            if os.path.exists(store):
                os.remove(store)

    one_ms = ranks(1, 0)[0]["ms"]
    out = ranks(n, DP_PROFILED)
    for r, o in enumerate(out):
        if (o["backend"], o["device"]) != ("nccl", f"cuda:{r}"):
            raise AssertionError(f"rank {r} ran on {o['backend']}, {o['device']}")
    first = out[0]["parity"]
    same = all(np.array_equal(v, o["parity"]["state_dict"][k])
               for o in out[1:] for k, v in first["state_dict"].items())
    ms = max(o["ms"] for o in out)
    rate, one = DP_BATCH * n / ms * 1e3, DP_BATCH / one_ms * 1e3
    losses = out[0]["losses"]
    print(f"dp cards: the same parameter bits on all {n} ranks: {same}")
    print(f"dp cards: recipe at {DP_BATCH} a card (global {DP_BATCH * n}), "
          f"{DP_TIMED[1]} steps: losses at steps 1, 10, {DP_TIMED[1]}: "
          f"{losses[0]:.4f}, {losses[9]:.4f}, {losses[-1]:.4f}; {ms:.3f} ms "
          f"per step (slowest rank; per rank "
          f"{[round(o['ms'], 3) for o in out]}), {rate:.0f} images/s, scaling "
          f"efficiency {rate / (n * one):.3f} against the same worker as "
          f"one rank on one card ({one_ms:.3f} ms per step, {one:.0f} "
          f"images/s), on {n} x {_card()}")
    _print_profile(out[0]["profile"], DP_PROFILED, ms, "dp cards rank 0")
    _dp_compare(f"DDP over {n} cards on NCCL ({64 // n} rows a card) vs the CPU",
                [h["loss"] for h in first["history"]],
                {k: torch.as_tensor(v) for k, v in first["state_dict"].items()},
                l_cpu, p_cpu)
    if not same:
        raise AssertionError("the ranks' parameters differ")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss across cards did not fall: {losses}")


def phase_dp(dev):
    """The data-parallel slice on the card: a one-rank NCCL group (NCCL
    refuses two ranks on one card; on one card every multi-rank check is a
    gloo test on the CPU), BatchNormCNN under MultiWorkerMirroredStrategy
    (DDP) against the CPU, the reference recipe trained and evaluated; the
    group destroyed, the same across every card where the machine has
    more than one (`_dp_cards`); then `mnist_multiworker.main` run as a
    user would (its `bootstrap()` at world size 1). Returns the recipe's
    ms per step through the old loop, which the lifecycle phase prints
    beside the Estimator's."""
    import torch.distributed as dist

    from tfde_tpu_torch import mnist_multiworker
    from tfde_tpu_torch.data import datasets

    train, test = datasets.mnist(flatten=True)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        parity_ref = _dp_parity(dev, *train)
        ms = _dp_train(dev, train, test)
    finally:
        dist.destroy_process_group()
    _dp_cards(parity_ref)
    t0 = time.perf_counter()
    state, metrics = mnist_multiworker.main(["--device", "cuda"])
    print(f"dp entry point: mnist_multiworker.main(['--device', 'cuda']): "
          f"{state.step} steps of PlainCNN through the Estimator, last "
          f"{json.dumps(metrics)} in {time.perf_counter() - t0:.1f} s")
    if state.step != 15 or not math.isfinite(metrics["loss"]):
        raise AssertionError(f"the entry point ended at step {state.step} "
                             f"with {metrics}")
    return ms


#: lifecycle: the recipe's steps, checkpoint interval, and the step after
#: which the child process interrupts itself
LC_STEPS, LC_SAVE, LC_KILL = 300, 100, 150
#: lifecycle: steps of the resumed run before its profiled window
LC_WARM = 5
#: lifecycle GPT: steps of the interrupted run, of the whole run, and the
#: checkpoint interval
LC_GPT_FIRST, LC_GPT_STEPS, LC_GPT_SAVE = 4, 6, 2


def _lc_old_loop_ms(dev, train):
    """ms per step of the dp phase's old loop (`global_batches` +
    `make_train_step`, the batch copied in the step) over steps 11-100,
    under the cuDNN settings in force."""
    from tfde_tpu_torch.mnist_multiworker import global_batches
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state, make_train_step

    model = BatchNormCNN(device=dev, seed=0)
    state = init_state(model, sgd(model, 0.2, momentum=0.9))
    step = make_train_step(MultiWorkerMirroredStrategy(), state)
    generator = torch.Generator(device=dev).manual_seed(0)
    for i, batch in enumerate(global_batches(*train, DP_BATCH, DP_TIMED[1])):
        if i == DP_TIMED[0]:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        step(state, batch, generator)
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / (DP_TIMED[1] - DP_TIMED[0])


def _lc_feed(dev, train, background):
    """`device_prefetch` alone (inline or with its worker thread) over the
    recipe's pipeline, nothing else running."""
    from tfde_tpu_torch.data import Dataset, device_prefetch
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy

    ds = (Dataset.from_tensor_slices(train).shuffle(len(train[0]), seed=0)
          .repeat().batch(DP_BATCH, drop_remainder=True))
    return device_prefetch(iter(ds), MultiWorkerMirroredStrategy(), dev,
                           background=background)


def _lc_feed_ms(dev, train, background=False):
    """ms per batch of the feed alone (`_lc_feed`: the host pull, the
    staging copy, the copy to the card) over batches 11-100."""
    feed = _lc_feed(dev, train, background)
    for i, _ in enumerate(feed):
        if i == DP_TIMED[0]:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        if i == DP_TIMED[1]:
            break
    torch.cuda.synchronize(dev)
    feed.close()
    return (time.perf_counter() - t0) * 1e3 / (DP_TIMED[1] - DP_TIMED[0])


def _lc_background_feed(dev, train):
    """The feed's background mode on the card: its first DP_TIMED[1]
    batches equal the inline feed's bit for bit. Returns (batches
    compared, its ms per batch over batches 11-100)."""
    inline, worker = _lc_feed(dev, train, False), _lc_feed(dev, train, True)
    n = 0
    for a, b in zip(inline, worker):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"the background feed's batch {n} differs "
                                 f"from the inline feed's")
        n += 1
        if n == DP_TIMED[1]:
            break
    inline.close()
    worker.close()
    return n, _lc_feed_ms(dev, train, background=True)


def _lc_recipe(dev, root, dp_ms):
    """The recipe through the Estimator to LC_STEPS (run A): ms per step and
    the feed's blocking share over steps 11-100 beside the old loop's
    (the dp phase's, and again here under cudnn.deterministic) and the
    feed's alone, the eval, a checkpoint's bytes and save and restore
    times, the idle share of DP_PROFILED more steps. Returns A's
    parameters and buffers at LC_STEPS, on the host."""
    from tfde_tpu_torch import testing
    from tfde_tpu_torch.checkpoint.manager import STATE_FILE, CheckpointManager
    from tfde_tpu_torch.data import Dataset, datasets
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state

    est, input_fn, start = testing.recipe(os.path.join(root, "a"), dev,
                                          batch=DP_BATCH, save_every=LC_SAVE)
    if start != 0:
        raise AssertionError(f"run A found a checkpoint at step {start}")
    clock, wait = {}, {}

    def hook(state, step):
        if step in DP_TIMED:
            torch.cuda.synchronize(dev)
            clock[step] = time.perf_counter()
            wait[step] = est.feed.wait_seconds

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = est.train(input_fn, LC_STEPS, _eval_hook=hook)
    wall = time.perf_counter() - t0
    a_params = {k: v.detach().cpu().clone()
                for k, v in est.model.state_dict().items()}
    loss = float(est.metrics["loss"])
    window = clock[DP_TIMED[1]] - clock[DP_TIMED[0]]
    ms = window * 1e3 / (DP_TIMED[1] - DP_TIMED[0])
    blocked = wait[DP_TIMED[1]] - wait[DP_TIMED[0]]
    train, (ex, ey) = datasets.mnist(flatten=True)
    old_det = _lc_old_loop_ms(dev, train)
    feed_ms = _lc_feed_ms(dev, train)
    compared, worker_ms = _lc_background_feed(dev, train)
    m = est.evaluate(lambda: Dataset.from_tensor_slices((ex, ey))
                     .batch(DP_EVAL_BATCH))
    old = "not run in this call" if dp_ms is None else f"{dp_ms:.3f} ms"
    print(f"lifecycle recipe: BatchNormCNN (dropout 0.5), global batch "
          f"{DP_BATCH}, sgd(0.2, momentum=0.9), cudnn.deterministic, Dataset "
          f"-> device_prefetch -> Estimator.train to step {state.step} on a "
          f"one-rank NCCL group ({wall:.1f} s, checkpoints every {LC_SAVE}); "
          f"last loss {loss:.4f}; max memory allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 20:.1f} MiB")
    print(f"lifecycle recipe: {ms:.3f} ms per step (mean of steps "
          f"{DP_TIMED[0] + 1}-{DP_TIMED[1]}, host clock after a synchronise; "
          f"the window holds step {DP_TIMED[1]}'s summary and checkpoint), "
          f"{DP_BATCH / ms * 1e3:.0f} images/s; the old loop (global_batches, "
          f"pageable copies in the step): {old} in the dp phase (cuDNN's "
          f"default algorithms), {old_det:.3f} ms here under "
          f"cudnn.deterministic; the feed's blocking share "
          f"{blocked / window:.4f} ({blocked * 1e3:.2f} ms of "
          f"{window * 1e3:.1f}); the feed alone {feed_ms:.3f} ms a batch "
          f"inline, {worker_ms:.3f} with background=True (its first "
          f"{compared} batches equal the inline feed's bit for bit); on "
          f"{_card()}")
    print(f"lifecycle eval: Estimator.evaluate over {len(ex)} test images in "
          f"batches of {DP_EVAL_BATCH} (the last {len(ex) % DP_EVAL_BATCH}): "
          f"{json.dumps(m)} (accuracy >= 0.95)")
    if not (math.isfinite(loss) and loss < 0.1):
        raise AssertionError(f"the Estimator's recipe ends at loss {loss}")
    if not m["accuracy"] >= 0.95:
        raise AssertionError(f"the Estimator's eval: {m}")

    # one checkpoint of the trained state: bytes, save (async: the part on
    # the loop, then the commit), restore into a fresh model
    mngr = CheckpointManager(os.path.join(root, "timing"))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    mngr.save(state)
    t1 = time.perf_counter()
    mngr.wait()
    t2 = time.perf_counter()
    path = os.path.join(root, "timing", str(state.step), STATE_FILE)
    model = BatchNormCNN(device=dev, seed=1)
    fresh = init_state(model, sgd(model, 0.2, momentum=0.9))
    t3 = time.perf_counter()
    CheckpointManager(os.path.join(root, "timing")).restore_latest(fresh)
    torch.cuda.synchronize(dev)
    t4 = time.perf_counter()
    same = all(torch.equal(v.cpu(), a_params[k])
               for k, v in model.state_dict().items())
    print(f"lifecycle checkpoint: {os.path.getsize(path)} bytes (parameters, "
          f"BatchNorm statistics, momentum, step); save {(t1 - t0) * 1e3:.2f} "
          f"ms on the loop (copy to host) + {(t2 - t1) * 1e3:.2f} ms to the "
          f"commit; restore {(t4 - t3) * 1e3:.2f} ms; restored bits equal: "
          f"{same}, on {_card()}")
    if not same or fresh.step != state.step:
        raise AssertionError("the restored checkpoint differs from the state")

    # the idle share of DP_PROFILED steady steps: the profiler runs from
    # the hook after step LC_STEPS + LC_WARM to the hook after the last of
    # them, so the feed's start, the first step and the final save fall
    # outside it
    from torch.profiler import ProfilerActivity, profile

    from tfde_tpu_torch.testing import profile_summary

    first = LC_STEPS + LC_WARM
    last = first + DP_PROFILED
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def window(state, step):
        if step in (first, last):
            torch.cuda.synchronize(dev)
            marks[step] = time.perf_counter()
            if step == first:
                prof.start()
            else:
                prof.stop()

    est.train(input_fn, last, _eval_hook=window)
    prof = profile_summary(prof, DP_PROFILED,
                           (marks[last] - marks[first]) * 1e3 / DP_PROFILED)
    _print_profile(prof, DP_PROFILED, ms, "lifecycle")
    est.close()
    return a_params


def _lc_resume(dev, root, a_params):
    """Run B, a child process interrupted by its own SIGTERM after step
    LC_KILL; run C resumes B's model_dir to LC_STEPS here and must end
    with run A's bits."""
    from tfde_tpu_torch import testing
    from tfde_tpu_torch.checkpoint.manager import CheckpointManager

    dir_b = os.path.join(root, "b")
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tfde_tpu_torch.testing", dir_b,
         os.path.join(root, "b.json"), "--device", "cuda", "--max-steps",
         str(LC_STEPS), "--batch", str(DP_BATCH), "--save-every",
         str(LC_SAVE), "--kill-after", str(LC_KILL)],
        env=env, capture_output=True, text=True, timeout=600)
    steps = CheckpointManager(os.path.join(dir_b, "checkpoints")).all_steps()
    print(f"lifecycle resume: run B (child process, SIGTERM to itself after "
          f"step {LC_KILL}) exit code {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s, checkpoints {steps}; "
          f"{proc.stderr.strip().splitlines()[-1] if proc.stderr else ''}")
    if proc.returncode != -15 or steps[-1:] != [LC_KILL]:
        raise AssertionError(f"run B: exit code {proc.returncode}, "
                             f"checkpoints {steps}:\n{proc.stderr[-3000:]}")
    est, input_fn, start = testing.recipe(dir_b, dev, batch=DP_BATCH,
                                          save_every=LC_SAVE)
    state = est.train(input_fn, LC_STEPS)
    est.close()
    c_params = est.model.state_dict()
    differ = [k for k, v in a_params.items()
              if not torch.equal(c_params[k].cpu(), v)]
    print(f"lifecycle resume: run C resumed at step {start} and ended at "
          f"{state.step}: {len(a_params) - len(differ)} of {len(a_params)} "
          f"parameters and buffers equal to run A's bit for bit (dropout "
          f"0.5 on)")
    if start != LC_KILL or state.step != LC_STEPS or differ:
        raise AssertionError(f"run C (from step {start}) differs from run A "
                             f"in {differ}")


def _lc_entry_point(root):
    """`mnist_multiworker.main` with --model-dir, twice: the second run must
    resume at step 10, end at 15, and say so in its log."""
    import logging

    from tfde_tpu_torch import mnist_multiworker

    d = os.path.join(root, "entry")
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep(logging.INFO)
    lc_log = logging.getLogger("tfde_tpu_torch.training.lifecycle")
    lc_log.addHandler(handler)
    level = lc_log.level
    lc_log.setLevel(logging.INFO)
    try:
        argv = ["--device", "cuda", "--model-dir", d]
        first, _ = mnist_multiworker.main(argv + ["--epochs", "2"])
        del records[:]
        second, metrics = mnist_multiworker.main(argv + ["--epochs", "3"])
    finally:
        lc_log.removeHandler(handler)
        lc_log.setLevel(level)
    resumed = [r for r in records if r.startswith("resuming at step")]
    print(f"lifecycle entry point: mnist_multiworker.main({argv} + "
          f"['--epochs', '2']) ended at step {first.step}; with --epochs 3: "
          f"{resumed}, ended at step {second.step}, last "
          f"{json.dumps(metrics)}")
    if (first.step, second.step) != (10, 15) or not resumed or not (
            resumed[0].startswith("resuming at step 10 of 15")):
        raise AssertionError(f"the entry point did not resume: {records}")


def _lc_gpt(fa, dev, root):
    """GPT-2 small through the Estimator with loss_fn/eval_fn: LC_GPT_FIRST
    steps with a checkpoint every LC_GPT_SAVE, a fresh Estimator resuming
    to LC_GPT_STEPS, against LC_GPT_STEPS uninterrupted steps; each run's
    flash launches counted from zero."""
    import itertools

    from tfde_tpu_torch.data import Dataset
    from tfde_tpu_torch.data.datasets import synthetic_tokens
    from tfde_tpu_torch.models.gpt import GPT2Small, next_token_loss
    from tfde_tpu_torch.training import Estimator, RunConfig
    from tfde_tpu_torch.training.optimizers import (
        adamw, warmup_cosine_decay_schedule)

    tokens = synthetic_tokens(64, 1024, vocab=50257, seed=2)
    ds = (Dataset.from_tensor_slices((tokens,)).shuffle(64, seed=0).repeat()
          .batch(8, drop_remainder=True))

    def eval_fn(model, batch, generator):
        loss, metrics = next_token_loss(model, batch, generator)
        return {"loss": loss, **metrics}

    def run(model_dir, steps, skip=0):
        model = GPT2Small(vocab_size=50257, max_position=1024,
                          dtype=torch.bfloat16, device=dev, seed=0)
        tx = adamw(model, warmup_cosine_decay_schedule(0.0, 3e-4, 2,
                                                       LC_GPT_STEPS),
                   weight_decay=0.1)
        est = Estimator(model, tx, config=RunConfig(
            model_dir=model_dir, save_checkpoints_steps=LC_GPT_SAVE,
            keep_checkpoint_max=1), loss_fn=next_token_loss, eval_fn=eval_fn)
        fa.flash_forward.launches = 0
        fa.flash_backward.dkv_launches = 0
        fa.flash_backward.dq_launches = 0
        t0 = time.perf_counter()
        state = est.train(lambda: itertools.islice(iter(ds), skip, None),
                          steps)
        torch.cuda.synchronize(dev)
        launches = (fa.flash_forward.launches, fa.flash_backward.dkv_launches,
                    fa.flash_backward.dq_launches)
        return est, state, launches, time.perf_counter() - t0

    whole, state, launches, secs = run(None, LC_GPT_STEPS)
    want = {k: v.detach().cpu() for k, v in whole.model.state_dict().items()}
    m = whole.evaluate(lambda: Dataset.from_tensor_slices((tokens[:16],))
                       .batch(8))
    whole.close()
    del whole
    checks = [(LC_GPT_STEPS, state.step, launches)]
    print(f"lifecycle gpt: GPT-2 small, bf16 compute, batch 8 x 1024, AdamW: "
          f"{state.step} uninterrupted steps through the Estimator in "
          f"{secs:.1f} s, launches fwd/dkv/dq {launches}; eval {json.dumps(m)}")
    d = os.path.join(root, "gpt")
    first, state, launches, secs = run(d, LC_GPT_FIRST)
    first.close()
    del first
    checks.append((LC_GPT_FIRST, state.step, launches))
    ckpt = os.path.join(d, "checkpoints", str(LC_GPT_FIRST), "state.pt")
    size = os.path.getsize(ckpt)
    resumed, state, launches, secs2 = run(d, LC_GPT_STEPS, LC_GPT_FIRST)
    resumed.close()
    checks.append((LC_GPT_STEPS - LC_GPT_FIRST, state.step - LC_GPT_FIRST,
                   launches))
    got = resumed.model.state_dict()
    differ = [k for k, v in want.items() if not torch.equal(got[k].cpu(), v)]
    print(f"lifecycle gpt: {LC_GPT_FIRST} steps with a checkpoint every "
          f"{LC_GPT_SAVE} ({size} bytes each) in {secs:.1f} s, then a fresh "
          f"Estimator resumed to {state.step} in {secs2:.1f} s, launches "
          f"fwd/dkv/dq {launches}: {len(want) - len(differ)} of {len(want)} "
          f"parameters equal to the uninterrupted run's bit for bit")
    del resumed
    for steps, ran, counts in checks:
        if ran != steps or counts != (12 * steps,) * 3:
            raise AssertionError(f"a GPT run of {steps} steps ran {ran} with "
                                 f"launches {counts}, not 12 a step")
    if differ or not math.isfinite(m["loss"]):
        raise AssertionError(f"the resumed GPT run differs in {differ} "
                             f"(eval {m})")


def phase_lifecycle(fa, dev, dp_ms=None):
    """The Estimator lifecycle on the card (docstring, phase 9): the recipe
    and its resume on a one-rank NCCL group under cudnn.deterministic,
    then the entry point and GPT-2 small with no group. Every model_dir
    lies under build/ and is removed at the end."""
    import shutil

    import torch.distributed as dist

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"lifecycle_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    try:
        torch.backends.cudnn.deterministic = True
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            a_params = _lc_recipe(dev, root, dp_ms)
            _lc_resume(dev, root, a_params)
        finally:
            dist.destroy_process_group()
            torch.backends.cudnn.deterministic = False
        _lc_entry_point(root)
        _lc_gpt(fa, dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: export: the batch sizes the served artifact must answer, its tolerance
#: against the restored model on the card (TF32 off) and against its own
#: serving on the CPU, and against the Estimator's final eval accuracy
EX_BATCHES, EX_TOL, EX_ACC_TOL = (1, 7, 128, 10000), 1e-5, 1e-4
#: export across cards: each rank's optimizer-state bytes at four ranks
#: (BatchNormCNN, momentum SGD, fp32): a quarter of Dense_0's weight
#: (58,800 of its 235,200 elements) and the 15,266 replicated elements
EX_PS_BYTES = {4: 4 * (58_800 + 15_266)}


def _ex_spawn(argv, root, name):
    """Start `python -m <argv>` in a child process from this checkout, with
    TF32 off (``NVIDIA_TF32_OVERRIDE=0``: torch's default runs cuDNN's
    convolutions in TF32, and the child's eval accuracy is held to the
    artifact's in fp32), its stderr into `root`/<name>.log; `_ex_wait`
    collects it."""
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    log = os.path.join(root, f"{name}.log")
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", *argv], env=env,
                                cwd=root, stdout=subprocess.DEVNULL,
                                stderr=f)
    return proc, log, time.perf_counter()


def _ex_wait(child, what):
    """(stderr log, seconds) of a `_ex_spawn` child; raises unless it
    exits 0 (a child past 900 s is killed)."""
    proc, log, t0 = child
    try:
        rc = proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    secs = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}:\n{text[-4000:]}")
    return text, secs


def _ex_child(argv, root, what):
    """`python -m <argv>` in a child process (`_ex_spawn`), waited for:
    (its stderr log, seconds)."""
    return _ex_wait(_ex_spawn(argv, root, what.replace(" ", "_")), what)


def _ex_evals(log):
    """The (step, metrics) of every eval an Estimator logged."""
    import ast
    import re

    return [(int(m[1]), ast.literal_eval(m[2])) for m in re.finditer(
        r"eval\[mnist-eval\] @ step (\d+): (\{.*\})", log)]


def _ex_recipe(dev, root, dp_ms):
    """`python -m tfde_tpu_torch.mnist_estimator` as a user runs it (one
    epoch); then its artifact served on the card against the restored
    model and against its own CPU serving, its accuracy against the
    final eval, and the export, bytes and times of an artifact."""
    import re

    from tfde_tpu_torch.checkpoint.manager import CheckpointManager
    from tfde_tpu_torch.data import datasets
    from tfde_tpu_torch.export import export_serving, load_serving
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.training.optimizers import sgd
    from tfde_tpu_torch.training.step import init_state

    d = os.path.join(root, "estimator")
    argv = ["tfde_tpu_torch.mnist_estimator", "--working-dir", d,
            "--num-epochs", "1", "--no-tensorboard"]
    log, secs = _ex_child(argv, root, "mnist_estimator")
    evals = _ex_evals(log)
    rates = [float(x) for x in re.findall(r"step \d+: ([\d.]+) steps/sec",
                                          log)]
    steps = CheckpointManager(os.path.join(d, "checkpoints")).all_steps()
    export_dir = os.path.join(d, "export", "exporter")
    stamps = sorted(os.listdir(export_dir)) if os.path.isdir(export_dir) else []
    old = "not run in this call" if dp_ms is None else f"{dp_ms:.3f} ms"
    step_ms = [round(1e3 / r, 3) for r in rates]
    print(f"export recipe: python -m {' '.join(argv)} (BatchNormCNN at the "
          f"reference widths, batch 128, sgd(0.01), ParameterServerStrategy "
          f"at one process: bootstrap builds no group, so the update is "
          f"replicated) exit 0 in {secs:.1f} s; checkpoints {steps}, "
          f"artifacts {stamps}; evals {evals}; ms per step by 100-step window "
          f"(1 / the logged steps/sec) {step_ms}, the dp phase's old loop "
          f"{old}; on {_card()}")
    if not (steps and steps[-1] == 468 and len(stamps) == 1 and evals
            and evals[-1][0] == 468 and math.isfinite(evals[-1][1]["loss"])):
        raise AssertionError(f"mnist_estimator: checkpoints {steps}, "
                             f"artifacts {stamps}, evals {evals}")
    final = evals[-1][1]

    # the artifact against the model restored from the last checkpoint
    _, (ex, ey) = datasets.mnist(flatten=True)
    model = BatchNormCNN(device=dev, seed=1)
    state = init_state(model, sgd(model, 0.01))
    CheckpointManager(os.path.join(d, "checkpoints")).restore_latest(state)
    served = load_serving(export_dir)
    on_cpu = load_serving(export_dir, device="cpu")
    x_all = torch.as_tensor(ex, device=dev)
    worst = {}
    with torch.no_grad():
        for n in EX_BATCHES:
            x = x_all[:n]
            got = served.module(x)
            live = torch.softmax(model(x), dim=-1)
            cpu = torch.as_tensor(on_cpu.predict(ex[:n]))
            if got.shape != (n, 10):
                raise AssertionError(f"served {tuple(got.shape)} for {n}")
            worst[n] = (float((got - live).abs().max()),
                        float((got.cpu() - cpu).abs().max()))
    probs = served.predict(ex)
    acc = float((probs.argmax(-1) == ey.reshape(-1)).mean())
    print(f"export served: {export_dir}/{stamps[0]} on {served.device}: "
          f"max abs against the restored model's softmax on the card and "
          f"against the same artifact served on the CPU, by batch size "
          f"{worst} (tol {EX_TOL:g}, TF32 off); argmax accuracy over "
          f"{len(ex)} test images {acc:.4f} against the final eval's "
          f"{final['accuracy']:.4f} (tol {EX_ACC_TOL:g})")
    if not (all(a <= EX_TOL and c <= EX_TOL for a, c in worst.values())
            and abs(acc - final["accuracy"]) <= EX_ACC_TOL):
        raise AssertionError("the served artifact disagrees")

    # an export of the restored model: seconds, bytes; served and live ms
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = export_serving(model, (None, 784), os.path.join(root, "timing"))
    export_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    x = x_all[:128]
    with torch.no_grad():
        served_ms = _time_ms(lambda: served.module(x), dev)
        live_ms = _time_ms(lambda: torch.softmax(model(x), dim=-1), dev)
        walls = []
        for fn in (lambda: served.module(x),
                   lambda: torch.softmax(model(x), dim=-1)):
            for _ in range(5):
                fn()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t0) * 1e3 / 50)
    print(f"export timing: export_serving of BatchNormCNN {export_s:.2f} s "
          f"(an eval copy traced by torch.export on the card, written); "
          f"artifact {size} bytes ({', '.join(sorted(os.listdir(out)))}); a batch of "
          f"128: served {served_ms:.4f} ms, live {live_ms:.4f} ms device "
          f"time (CUDA events, L2 flushed); {walls[0]:.4f} and "
          f"{walls[1]:.4f} ms a call on the host clock over 50 calls; on "
          f"{_card()}")


def _ex_best(dev, root):
    """train_and_evaluate with a BestExporter over two throttled evals (a
    throttle of 0: one after each of 2 steps) and the final one: the
    newest artifact must be the one best_metric.json names."""
    from tfde_tpu_torch.data import Dataset, datasets
    from tfde_tpu_torch.export import BestExporter
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.parallel.strategies import ParameterServerStrategy
    from tfde_tpu_torch.training import (
        Estimator, EvalSpec, RunConfig, TrainSpec, train_and_evaluate)
    from tfde_tpu_torch.training.optimizers import sgd

    (tx, ty), (ex, ey) = datasets.mnist(flatten=True)
    d = os.path.join(root, "best")
    model = BatchNormCNN(device=dev, seed=0)
    est = Estimator(model, sgd(model, 0.2, momentum=0.9),
                    ParameterServerStrategy(),
                    RunConfig(model_dir=d, save_checkpoints_steps=None))
    def eval_fn():
        return Dataset.from_tensor_slices((ex, ey)).batch(DP_EVAL_BATCH)

    _, final = train_and_evaluate(
        est, TrainSpec(lambda: Dataset.from_tensor_slices((tx, ty))
                       .shuffle(len(tx), seed=0).repeat()
                       .batch(DP_BATCH, drop_remainder=True), 2),
        EvalSpec(eval_fn, exporters=[BestExporter("best", (None, 784))],
                 start_delay_secs=0, throttle_secs=0))
    est.close()
    best = os.path.join(d, "export", "best")
    stamps = sorted((x for x in os.listdir(best) if x.isdigit()), key=int)
    with open(os.path.join(best, "best_metric.json")) as f:
        bar = json.load(f)
    print(f"export best: BestExporter over the evals after steps 1 and 2 and "
          f"the final one ({final}): artifacts {stamps}, best_metric.json "
          f"{bar}")
    if bar["artifact"] != os.path.join(best, stamps[-1]):
        raise AssertionError("the newest artifact is not the best one")


def _ex_tf2_start(root):
    """The second recipe: mnist_tf2's custom loop and its Estimator, two
    child processes started together (neither is timed against anything:
    each prints its own wall); `_ex_tf2` waits for them."""
    return (_ex_spawn(["tfde_tpu_torch.mnist_tf2", "--custom-loop",
                       "--max-steps", "100"], root, "tf2_custom"),
            _ex_spawn(["tfde_tpu_torch.mnist_tf2", "--model-dir",
                       os.path.join(root, "tf2"), "--max-steps", "200"],
                      root, "tf2_estimator"))


def _ex_tf2(root, children):
    """The two mnist_tf2 children of `_ex_tf2_start`, held."""
    import re

    log, secs = _ex_wait(children[0], "mnist_tf2 custom")
    m = re.search(r"custom loop done: step=(\d+) loss=([\d.naif]+)", log)
    d2 = os.path.join(root, "tf2")
    log2, secs2 = _ex_wait(children[1], "mnist_tf2")
    evals = _ex_evals(log2)
    stamps = os.listdir(os.path.join(d2, "export", "exporter"))
    print(f"export tf2: --custom-loop --max-steps 100: {m and m.group(0)} "
          f"({secs:.1f} s); --model-dir --max-steps 200: final eval "
          f"{evals[-1] if evals else None}, artifacts {stamps} "
          f"({secs2:.1f} s; the two ran together, beside the exported GPT's "
          f"check)")
    if not (m and int(m[1]) == 100 and math.isfinite(float(m[2])) and evals
            and evals[-1][0] == 200 and math.isfinite(evals[-1][1]["loss"])
            and len(stamps) == 1):
        raise AssertionError("mnist_tf2 did not end as it should")


#: a child process that loads an artifact on the card with the flash
#: launch counters zeroed: argv[1] "serving" or "generate", the artifact,
#: the input ids (.npy), the output (.npy); prints its launches as JSON
ARTIFACT_CHILD = """
import json, sys
import numpy as np
from tfde_tpu_torch.export import load_generate, load_serving
from tfde_tpu_torch.ops import flash_attention as fa
kind, path, ids_npy, out_npy = sys.argv[1:5]
ids = np.load(ids_npy)
fa.reset_launches()
if kind == "serving":
    out = load_serving(path).predict(ids)
else:
    out = load_generate(path).generate(ids, seed=int(sys.argv[5]))[0]
np.save(out_npy, out)
print(json.dumps({"fwd": fa.flash_forward.launches,
                  "fwd_by_head_dim": dict(fa.flash_forward.by_head_dim)}))
"""


def _artifact_child(kind, path, ids, root, *extra):
    """`ARTIFACT_CHILD` on `path` with `ids`: (its output, its launches,
    seconds); raises unless it exits 0."""
    here = os.path.dirname(os.path.abspath(__file__))
    ids_npy = os.path.join(root, f"{kind}_ids.npy")
    out_npy = os.path.join(root, f"{kind}_out.npy")
    np.save(ids_npy, ids)
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", ARTIFACT_CHILD, kind, path, ids_npy, out_npy,
         *map(str, extra)], cwd=here, env=env, capture_output=True,
        text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"the {kind} artifact child exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return (np.load(out_npy), json.loads(proc.stdout.strip().splitlines()[-1]),
            secs)


def _artifact_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _ex_flash_gpt(fa, dev, root):
    """A GPT whose forward launches the flash kernel on the card exports
    (the trace launches nothing: fake tensors), and its artifact, loaded
    in a fresh process on the card, launches the kernel once a layer and
    gives the live model's logits, bit for bit."""
    from tfde_tpu_torch.export import export_serving
    from tfde_tpu_torch.models.gpt import GPT

    model = GPT(vocab_size=97, hidden_size=128, depth=2, num_heads=2,
                mlp_dim=256, max_position=64, dtype=torch.bfloat16,
                device=dev)
    ids = np.random.default_rng(8).integers(0, 97, (3, 16))
    _zero_counts(fa)
    t0 = time.perf_counter()
    path = export_serving(model, (None, 16), os.path.join(root, "gpt"),
                          input_dtype=torch.int64, apply_softmax=False)
    export_s, traced = time.perf_counter() - t0, _counts(fa)
    with torch.no_grad():
        live = model(torch.as_tensor(ids, device=dev)).cpu().numpy()
    live_launches = _counts(fa)[0]
    served, child, child_s = _artifact_child("serving", path, ids, root)
    same = bool(np.array_equal(served, live))
    err = float(np.abs(served - live).max())
    print(f"export gpt: a bf16 GPT (head dim 64, 2 layers) on the card "
          f"exported in {export_s:.2f} s ({_artifact_bytes(path):,} bytes; "
          f"flash launches while tracing {traced}); served in a fresh "
          f"process on the card ({child_s:.1f} s): flash launches "
          f"{child['fwd']} (live {live_launches}), logits equal to the live "
          f"model's bit for bit: {same} (max abs {err:.3e})")
    if traced != (0, 0, 0) or live_launches != 2 or child["fwd"] != 2:
        raise AssertionError("the exported GPT did not launch the flash "
                             "kernel once a layer on both sides")
    if not same:
        raise AssertionError("the served GPT's logits differ from the live "
                             "model's")


def _ex_cards():
    """On a machine with two cards or more: ParameterServerStrategy, one
    process a card on NCCL (`testing.ps_ranks_worker`), against the
    mirrored run of the same steps; the same bits on every rank, and each
    rank's optimizer-state bytes."""
    from tfde_tpu_torch.data import datasets
    from tfde_tpu_torch.models.cnn import BatchNormCNN
    from tfde_tpu_torch.testing import ps_ranks_worker, run_ranks

    n = torch.cuda.device_count()
    if n < 2:
        print(f"export cards: {n} card on this machine; the run across cards "
              f"needs two or more (not run)")
        return
    (tx, ty), _ = datasets.mnist(flatten=True, n_train=320, n_test=8)
    batches = [(tx[i * 64:(i + 1) * 64], ty[i * 64:(i + 1) * 64])
               for i in range(5)]
    initial = {k: v.numpy() for k, v in BatchNormCNN(
        dropout_rate=0.0, device="cpu", seed=0).state_dict().items()}
    store = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", f"ps_store_{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    try:
        out = run_ranks(ps_ranks_worker, [
            (n, store, ("BatchNormCNN", initial, batches, 0.05, 0.9))] * n,
            timeout=600)
    finally:
        if os.path.exists(store):
            os.remove(store)
    ps = [o["ParameterServerStrategy"] for o in out]
    mirrored = out[0]["MultiWorkerMirroredStrategy"]
    same = all(np.array_equal(v, o["state_dict"][k]) for o in ps[1:]
               for k, v in ps[0]["state_dict"].items())
    err = max(float(np.abs(v - mirrored["state_dict"][k]).max())
              for k, v in ps[0]["state_dict"].items())
    bits = err == 0.0
    opt_bytes = [o["opt_state_bytes"] for o in ps]
    print(f"export cards: ParameterServerStrategy over {n} cards on NCCL "
          f"(BatchNormCNN, 5 sgd(0.05, momentum 0.9) steps of 64, "
          f"cudnn.deterministic): the same bits on every rank: {same}; "
          f"against the mirrored run max abs {err:.3e} (bits equal: {bits}); "
          f"optimizer-state bytes a rank {opt_bytes} (mirrored "
          f"{mirrored['opt_state_bytes']}), on {n} x {_card()}")
    if not same or err > 1e-7:
        raise AssertionError("the PS run across cards disagrees")
    if n in EX_PS_BYTES and set(opt_bytes) != {EX_PS_BYTES[n]}:
        raise AssertionError(f"optimizer-state bytes {opt_bytes}, not "
                             f"{EX_PS_BYTES[n]}")


def phase_export(fa, dev, dp_ms=None):
    """The reference's two Estimator recipes and the serving export on the
    card (docstring, phase 10). Every directory lies under build/ and is
    removed at the end."""
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"export_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    tf2 = ()
    try:
        _ex_recipe(dev, root, dp_ms)
        _ex_best(dev, root)
        tf2 = _ex_tf2_start(root)
        _ex_flash_gpt(fa, dev, root)
        _ex_tf2(root, tf2)
        _ex_cards()
    finally:
        for proc, _log, _t0 in tf2:  # a failure above leaves none running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)


#: resnet: the recipe's global batch, steps, timed window (steps after the
#: first of these up to the last), steps before the profiled window and
#: profiled steps, the entry point's steps; the streaming check's shards
#: and shuffle window
RN_BATCH, RN_STEPS, RN_TIMED, RN_WARM, RN_PROFILED = 128, 200, (50, 200), 5, 10
RN_ENTRY_STEPS, RN_SHARDS, RN_WINDOW = 20, 8, 8192
#: resnet parity: the bf16 model's eval logits, card against CPU (relative
#: Frobenius): a bf16 rounding at every conv and BatchNorm output, where
#: a sum in another order flips the last bit (the CPU tests hold the port's
#: bf16 model to the JAX one at the same bound)
RN_BF16_TOL = 1e-2


def _row_sums(images: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """One uint64 fingerprint a row: its image's 32-bit words and its label
    times fixed odd weights, summed modulo 2^64."""
    words = np.ascontiguousarray(images).reshape(len(images), -1)
    words = words.view(np.uint32).astype(np.uint64)
    w = (np.random.default_rng(7).integers(1, 2 ** 62, words.shape[1],
                                           dtype=np.uint64) | np.uint64(1))
    with np.errstate(over="ignore"):
        return ((words * w).sum(axis=1, dtype=np.uint64)
                + labels.reshape(-1).astype(np.uint64) * np.uint64(0x9E37))


def _rn_native(root, train):
    """The native library: g++ build seconds; one epoch of the training set
    through NativeBatchLoader (batch 128, seed 0) must hold every row
    once; its batches/s beside the Dataset path's; the native crc32c
    against the table walk on 1 MiB, and both rates."""
    from tfde_tpu_torch import native
    from tfde_tpu_torch.data import Dataset
    from tfde_tpu_torch.observability.tensorboard import crc32c_table

    t0 = time.perf_counter()
    native.compile_library(os.path.join(root, "native", "loader.so"))
    build_s = time.perf_counter() - t0
    if not native.available():
        raise AssertionError("the native loader's library did not load")
    x, y = train
    want = np.sort(_row_sums(x, y))

    def epoch(batches):
        t0 = time.perf_counter()
        sums, labels, n = [], [], 0
        for bx, by in batches:
            sums.append(_row_sums(bx, by))
            labels.append(by.reshape(-1).copy())
            n += 1
        return time.perf_counter() - t0, n, np.concatenate(sums), \
            np.concatenate(labels)

    secs, n, sums, labels = epoch(native.NativeBatchLoader(
        [x, y], batch_size=RN_BATCH, seed=0, repeat=1))
    ds_secs, ds_n, ds_sums, _ = epoch(
        Dataset.from_tensor_slices((x, y)).shuffle(len(x), seed=0)
        .batch(RN_BATCH))
    # the timed loops above fingerprint every row; the loaders alone:
    t0 = time.perf_counter()
    bare = sum(1 for _ in native.NativeBatchLoader([x, y], RN_BATCH, seed=0,
                                                   repeat=1))
    bare_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds_bare = sum(1 for _ in Dataset.from_tensor_slices((x, y))
                  .shuffle(len(x), seed=0).batch(RN_BATCH))
    ds_bare_s = time.perf_counter() - t0
    counts_ok = np.array_equal(np.bincount(labels, minlength=10),
                               np.bincount(y.reshape(-1), minlength=10))
    once = np.array_equal(np.sort(sums), want) and len(sums) == len(x)
    data = np.random.default_rng(1).integers(0, 256, 2 ** 20,
                                             dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    for _ in range(64):
        got = native.crc32c(data)
    crc_s = (time.perf_counter() - t0) / 64
    t0 = time.perf_counter()
    table = crc32c_table(data)
    table_s = time.perf_counter() - t0
    print(f"resnet native: g++ build {build_s:.2f} s; one epoch of {len(x)} "
          f"rows at batch {RN_BATCH}, seed 0: {n} batches, every row once: "
          f"{once}, label counts equal: {counts_ok}; {bare / bare_s:.0f} "
          f"batches/s (NativeBatchLoader) vs {ds_bare / ds_bare_s:.0f} "
          f"(Dataset shuffle+batch), {n / secs:.0f} vs {ds_n / ds_secs:.0f} "
          f"with a fingerprint of every row; crc32c of 1 MiB native "
          f"{got:#010x} = table {table:#010x}: {got == table}, "
          f"{len(data) / crc_s / 1e6:.0f} MB/s native vs "
          f"{len(data) / table_s / 1e6:.2f} MB/s table, on the host")
    if not (once and counts_ok and n == -(-len(x) // RN_BATCH)
            and np.array_equal(np.sort(ds_sums), want) and got == table):
        raise AssertionError("the native loader or crc32c disagrees")


def _rn_streaming(dev, root, train):
    """The training set as RN_SHARDS TFRecord shards, one epoch through
    StreamingTFRecordLoader (window RN_WINDOW, seed 0, batch RN_BATCH) and
    device_prefetch to the card: the rows that arrive must be the rows
    written, as a multiset; records/s."""
    from tfde_tpu_torch.data.device import device_prefetch
    from tfde_tpu_torch.data.streaming import StreamingTFRecordLoader
    from tfde_tpu_torch.data.tfrecord import write_tfrecord
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.runtime.mesh import LocalMesh

    x, y = train
    shape = x.shape[1:]
    t0 = time.perf_counter()
    paths = []
    for s in range(RN_SHARDS):
        path = os.path.join(root, f"cifar-{s:02d}.tfrecord")
        write_tfrecord(path, (x[i].tobytes() + y[i].tobytes()
                              for i in range(s, len(x), RN_SHARDS)))
        paths.append(path)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(p) for p in paths)

    def parse(rec):
        return (np.frombuffer(rec[:-8], np.float32).reshape(shape),
                np.frombuffer(rec[-8:], np.int64))

    loader = StreamingTFRecordLoader(paths, parse, batch_size=RN_BATCH,
                                     window=RN_WINDOW, seed=0, repeat=1)
    feed = device_prefetch(loader, MultiWorkerMirroredStrategy(
        mesh=LocalMesh(("data",))), dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    batches = list(feed)  # every batch on the card before any is read
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    on_card = all(t.device == dev for b in batches for t in b)
    sums = np.concatenate([_row_sums(bx.cpu().numpy(), by.cpu().numpy())
                           for bx, by in batches])
    same = np.array_equal(np.sort(sums), np.sort(_row_sums(x, y)))
    print(f"resnet streaming: {len(x)} rows as {RN_SHARDS} TFRecord shards "
          f"({nbytes} bytes, written in {write_s:.2f} s); one epoch through "
          f"StreamingTFRecordLoader (window {RN_WINDOW}, seed 0, batch "
          f"{RN_BATCH}) and device_prefetch to the card: {len(batches)} "
          f"batches on {dev}: {on_card}, the rows written as a multiset: "
          f"{same}; {len(sums) / secs:.0f} records/s (read, CRC, parse, "
          f"shuffle, gather, stage), on {_card()}")
    if not (on_card and same and len(sums) == len(x)):
        raise AssertionError("the streamed rows differ from those written")


def _zero_counts(fa) -> None:
    fa.reset_launches()


def _counts(fa) -> tuple:
    return (fa.flash_forward.launches, fa.flash_backward.dkv_launches,
            fa.flash_backward.dq_launches)


def _rn_parity(dev):
    """A tiny ResNet (stage_sizes [1, 1], 16 filters, CIFAR stem) with each
    block, fp32 with TF32 off, on the same weights on the card and the CPU:
    eval logits, and one make_train_step (DDP on a one-rank NCCL group on
    the card, no group on the CPU) held to DP_TOL: loss, every gradient
    tensor, the updated parameters and running statistics as one vector
    and tensor by tensor, first with cuDNN's default algorithms, then, if
    a tensor is off, under cudnn.deterministic; then the bf16 model's
    logits within RN_BF16_TOL."""
    import torch.distributed as dist

    from tfde_tpu_torch import testing

    rng = np.random.default_rng(0)
    images = rng.random((32, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, (32, 1)).astype(np.int64)
    schedule = (0.1, 0, 3)  # no warmup: the first update moves the weights
    for block in ("BottleneckBlock", "BasicBlock"):
        spec = dict(stage_sizes=[1, 1], block=block, num_filters=16,
                    dtype="float32", cifar_stem=True)
        sd = {k: v.numpy().copy() for k, v in
              testing.resnet_model(spec, "cpu").state_dict().items()}
        for k in sd:  # the zero-initialised scales would hide their convs
            if k.endswith("weight") and sd[k].ndim == 1:
                sd[k] = sd[k] + rng.normal(0, 0.3, sd[k].shape).astype(
                    np.float32)
            elif k.endswith("running_var"):
                sd[k] = sd[k] + rng.uniform(0.2, 1.0, sd[k].shape).astype(
                    np.float32)
        logits = {}
        for where in ("cpu", dev):
            model = testing.resnet_model(spec, where)
            model.load_state_dict({k: torch.as_tensor(v) for k, v in
                                   sd.items()})
            with torch.no_grad():
                logits[str(where)] = model(torch.as_tensor(
                    images, device=where)).cpu()
        eval_rel = _rel(logits[str(dev)], logits["cpu"])
        cpu = testing.train_resnet(spec, sd, [(images, labels)], schedule)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            runs = {}
            for deterministic in (False, True):
                torch.backends.cudnn.deterministic = deterministic
                try:
                    runs[deterministic] = testing.train_resnet(
                        spec, sd, [(images, labels)], schedule, device=dev)
                finally:
                    torch.backends.cudnn.deterministic = False
        finally:
            dist.destroy_process_group()

        def errors(run):
            loss = abs(run["history"][0]["loss"] - cpu["history"][0]["loss"]
                       ) / abs(cpu["history"][0]["loss"])
            grads = _grads_rel({k: torch.as_tensor(v) for k, v in
                                run["grads"].items()},
                               {k: torch.as_tensor(v) for k, v in
                                cpu["grads"].items()})
            got = {k: torch.as_tensor(v) for k, v in run["state_dict"].items()}
            want = {k: torch.as_tensor(v) for k, v in
                    cpu["state_dict"].items()}
            vec = _rel(torch.cat([got[k].flatten() for k in want]),
                       torch.cat([v.flatten() for v in want.values()]))
            tensor = max(_rel(got[k], v) for k, v in want.items())
            return loss, grads, vec, tensor

        def ok(e, per_tensor):
            loss, grads, vec, tensor = e
            return (loss <= DP_TOL["loss"] and vec <= DP_TOL["params_rel"]
                    and (not per_tensor or (grads <= DP_TOL["tensor_rel"]
                                            and tensor <= DP_TOL["tensor_rel"])))

        default, determ = errors(runs[False]), errors(runs[True])
        needed = not ok(default, True)
        print(f"resnet parity: {block} ResNet(stage_sizes=[1, 1], 16 "
              f"filters, CIFAR stem), fp32, TF32 off, 32 images: eval logits "
              f"card vs CPU rel {eval_rel:.3e} (tol 1e-5); one make_train_step "
              f"(sgd nesterov, warmup-cosine) as DDP on a one-rank NCCL group "
              f"vs the CPU: (loss rel, worst gradient rel, parameters and "
              f"statistics as one vector rel, worst single tensor rel) with "
              f"cuDNN's default algorithms "
              f"{tuple(float(f'{v:.3e}') for v in default)}, under "
              f"cudnn.deterministic {tuple(float(f'{v:.3e}') for v in determ)}"
              f" (DP_TOL: loss {DP_TOL['loss']:g}, vector "
              f"{DP_TOL['params_rel']:g}, tensors {DP_TOL['tensor_rel']:g}); "
              f"cudnn.deterministic needed: {needed}")
        if not (eval_rel <= 1e-5 and ok(default, False)
                and ok(determ, True)):
            raise AssertionError(f"the {block} ResNet on the card disagrees "
                                 f"with the CPU")
        spec16 = dict(spec, dtype="bfloat16")
        logits16 = {}
        for where in ("cpu", dev):
            model = testing.resnet_model(spec16, where)
            model.load_state_dict({k: torch.as_tensor(v) for k, v in
                                   sd.items()})
            with torch.no_grad():
                logits16[str(where)] = model(torch.as_tensor(
                    images, device=where)).cpu()
        rel16 = _rel(logits16[str(dev)], logits16["cpu"])
        print(f"resnet parity: {block}, bf16 trunk: eval logits card vs CPU "
              f"rel {rel16:.3e} (tol {RN_BF16_TOL:g})")
        if not rel16 <= RN_BF16_TOL:
            raise AssertionError(f"the bf16 {block} ResNet on the card "
                                 f"disagrees with the CPU")


def _rn_recipe(fa, dev):
    """resnet50_cifar (bf16 trunk, fp32 master weights, seed 0) from
    make_train_dataset(RN_BATCH, use_native=True) through Estimator.train
    under MultiWorkerMirroredStrategy on a one-rank NCCL group, with the
    entry point's schedule and optimizer at max_steps RN_STEPS: ms per
    step and images/s over the RN_TIMED window, memory, every loss; then
    RN_PROFILED more steps profiled (after RN_WARM), the all-reduces a
    step; the flash kernels must not launch."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from tfde_tpu_torch import cifar10_resnet
    from tfde_tpu_torch.data.pipeline import AutoShardPolicy
    from tfde_tpu_torch.models.resnet import resnet50_cifar
    from tfde_tpu_torch.parallel.strategies import MultiWorkerMirroredStrategy
    from tfde_tpu_torch.testing import profile_summary
    from tfde_tpu_torch.training import Estimator
    from tfde_tpu_torch.training.optimizers import (
        sgd, warmup_cosine_decay_schedule)
    from tfde_tpu_torch.training.step import make_train_step

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        model = resnet50_cifar(device=dev, seed=0)
        peak = 0.4 * RN_BATCH / 1024.0
        warmup = min(100, max(RN_STEPS - 1, 1))  # the entry point's
        tx = sgd(model, warmup_cosine_decay_schedule(0.0, peak, warmup,
                                                     RN_STEPS),
                 momentum=0.9, nesterov=True)
        strategy = MultiWorkerMirroredStrategy()
        est = Estimator(model, tx, strategy)
        # every step's loss, kept on the card: the Estimator keeps only the
        # last step's metrics, and a read a step would sync the loop
        step_fn = make_train_step(strategy, est._ensure_state())
        kept = []

        def recording(state, batch, generator):
            state, metrics = step_fn(state, batch, generator)
            kept.append(metrics["loss"])
            return state, metrics

        est._train_step = recording
        clock, wait = {}, {}

        def hook(state, step):
            if step in RN_TIMED:
                torch.cuda.synchronize(dev)
                clock[step] = time.perf_counter()
                wait[step] = est.feed.wait_seconds

        def input_fn():
            return cifar10_resnet.make_train_dataset(RN_BATCH,
                                                     use_native=True)

        _zero_counts(fa)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        steps = est.train(input_fn, RN_STEPS, AutoShardPolicy.OFF,
                          _eval_hook=hook).step
        wall = time.perf_counter() - t0
        flash = _counts(fa)
        losses = [float(x) for x in kept]
        window_s = clock[RN_TIMED[1]] - clock[RN_TIMED[0]]
        ms = window_s * 1e3 / (RN_TIMED[1] - RN_TIMED[0])
        blocked = wait[RN_TIMED[1]] - wait[RN_TIMED[0]]
        mem = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        first, last = RN_STEPS + RN_WARM, RN_STEPS + RN_WARM + RN_PROFILED
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        marks = {}

        def window(state, step):
            if step in (first, last):
                torch.cuda.synchronize(dev)
                marks[step] = time.perf_counter()
                if step == first:
                    prof.start()
                else:
                    prof.stop()

        est.train(input_fn, last, AutoShardPolicy.OFF, _eval_hook=window)
        est.close()
    finally:
        dist.destroy_process_group()
    summary = profile_summary(prof, RN_PROFILED,
                              (marks[last] - marks[first]) * 1e3
                              / RN_PROFILED)
    reduces = {k: calls for k, _, calls in summary["host"]
               if "all_reduce" in k.lower() or "allreduce" in k.lower()}
    nccl_ms = sum(ms for k, ms in summary["device"] if "nccl" in k.lower())
    print(f"resnet recipe: resnet50_cifar (23,520,842 parameters, bf16 "
          f"trunk, fp32 master weights and head), seed 0, "
          f"make_train_dataset({RN_BATCH}, use_native=True) -> "
          f"device_prefetch -> Estimator.train under {strategy.describe()} "
          f"as DDP on a one-rank NCCL group, sgd(nesterov, momentum 0.9), "
          f"warmup {warmup} + cosine to {RN_STEPS}, peak lr {peak:g}: "
          f"{steps} steps in {wall:.1f} s; losses by step "
          f"{ {i: round(losses[i - 1], 4) for i in (1, 10, 50, 100, RN_STEPS) if i <= len(losses)} }")
    print(f"resnet recipe: {ms:.3f} ms per step (mean of steps "
          f"{RN_TIMED[0] + 1}-{RN_TIMED[1]}, host clock after a synchronise), "
          f"{RN_BATCH / ms * 1e3:.0f} images/s, max memory allocated "
          f"{mem:.2f} GiB; the feed's blocking share {blocked / window_s:.4f}"
          f" ({blocked * 1e3:.1f} ms of {window_s * 1e3:.1f}); on {_card()}")
    print(f"resnet recipe: all-reduce calls a step (profiled host ops) "
          f"{json.dumps(reduces)}, NCCL device ms a step {nccl_ms:.3f} (at "
          f"one rank the BatchNorms reduce nothing: their 53 statistics "
          f"all-reduces, and 53 more for the gradient, run at two ranks or "
          f"more)")
    _print_profile(summary, RN_PROFILED, ms, "resnet")
    head, tail = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
    print(f"resnet recipe: mean loss of the first 20 steps {head:.4f}, of "
          f"the last 20 {tail:.4f}; flash launches {list(flash)} (must be 0)")
    if not all(math.isfinite(x) for x in losses) or len(losses) != RN_STEPS:
        raise AssertionError(f"non-finite or missing losses: {losses}")
    if not tail < head:
        raise AssertionError(f"the loss did not fall: {head} -> {tail}")
    if any(flash):
        raise AssertionError(f"the ResNet path launched flash kernels: "
                             f"{flash}")


#: entry-point children queued by the resnet, bert and vit phases, as
#: (argv, what, steps, check); `_entry_flush` runs them together
_ENTRY_QUEUE = []


def _entry_child(argv, what, steps, check=None):
    """Queue `python -m <argv>` for a child process (`_ex_spawn`), which
    must exit 0 and log that it is done at `steps`, and pass `check(log)`.
    The queued children run together in `_entry_flush`, after the phases
    that queue them: none overlaps another phase's timed work, and each
    prints only its own wall."""
    _ENTRY_QUEUE.append((argv, what, steps, check))


def _entry_flush():
    """Start every queued entry-point child at once, each in a directory of
    its own under build/ (removed after), then hold each. A failure kills
    the others."""
    import shutil

    queued = list(_ENTRY_QUEUE)
    _ENTRY_QUEUE.clear()
    if not queued:
        return
    here = os.path.dirname(os.path.abspath(__file__))
    roots, children = [], []
    t0 = time.perf_counter()
    try:
        for argv, what, _steps, _check in queued:
            roots.append(os.path.join(here, "build",
                                      f"entry_{what}_{os.getpid()}"))
            shutil.rmtree(roots[-1], ignore_errors=True)
            os.makedirs(roots[-1])
            children.append(_ex_spawn(argv, roots[-1], what))
        ended = {}
        while len(ended) < len(children):  # each child's own wall
            for i, (proc, _log, _t0) in enumerate(children):
                if i not in ended and proc.poll() is not None:
                    ended[i] = time.perf_counter()
            if time.perf_counter() - t0 > 900:
                raise AssertionError("an entry point ran past 900 s")
            time.sleep(0.2)
        for i, (argv, what, steps, check) in enumerate(queued):
            log, _secs = _ex_wait(children[i], what)
            secs = ended[i] - children[i][2]
            done = [line for line in log.splitlines()
                    if "done at step" in line]
            fed = [line for line in log.splitlines() if "input: " in line]
            print(f"{what} entry point: python -m {' '.join(argv)} exit 0 "
                  f"in {secs:.1f} s (beside {len(queued) - 1} other entry "
                  f"points); {fed + done}")
            if not (done and f"done at step {steps} (" in done[-1]
                    and (check is None or check(log))):
                raise AssertionError(f"{what}: {log[-3000:]}")
    finally:
        for proc, _log, _t0 in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
    print(f"entry points ({', '.join(q[1] for q in queued)}) together: "
          f"{time.perf_counter() - t0:.1f} s")


def _rn_entry_point():
    """`python -m tfde_tpu_torch.cifar10_resnet --max-steps RN_ENTRY_STEPS`
    in a child process, as a user runs it (`_entry_child`), fed by the
    native loader."""
    def native(log):
        fed = [line for line in log.splitlines() if "input: " in line]
        return bool(fed) and "the native loader" in fed[-1]

    _entry_child(["tfde_tpu_torch.cifar10_resnet", "--max-steps",
                  str(RN_ENTRY_STEPS)], "cifar10_resnet", RN_ENTRY_STEPS,
                 native)


def phase_resnet(fa, dev):
    """CIFAR-10 ResNet-50 and the host input pipeline on the card
    (docstring, phase 11). Every file lies under build/ and is removed at
    the end."""
    import shutil

    from tfde_tpu_torch.data import datasets

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"resnet_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    load = datasets.cifar10
    try:
        t0 = time.perf_counter()
        arrays = load()
        source = ("a local cifar10.npz" if datasets._find("cifar10.npz")
                  else "the synthetic stand-in")
        print(f"resnet: CIFAR-10 ({len(arrays[0][0])} training rows, "
              f"{source}) in {time.perf_counter() - t0:.1f} s, made once "
              f"for the phase")
        datasets.cifar10 = lambda: arrays  # the recipe's input_fn reloads
        _rn_native(root, arrays[0])
        _rn_streaming(dev, root, arrays[0])
        _rn_parity(dev)
        _rn_recipe(fa, dev)
        _rn_entry_point()
    finally:
        datasets.cifar10 = load
        shutil.rmtree(root, ignore_errors=True)


#: the encoders' attention shapes (B, S, H, D), bf16, non-causal, unmasked:
#: BERT-base at 64 x 128 tokens, ViT-B/16 at 256 images of 197 tokens
BERT_SHAPE, VIT_SHAPE = (64, 128, 12, 64), (256, 197, 12, 64)
#: bert: steps of the recipe through bert_mlm.main, the window timed
#: (steps BERT_TIMED[0] + 1 .. BERT_TIMED[1]), steps profiled after it, the
#: entry point's steps in a child
BERT_STEPS, BERT_TIMED, BERT_PROFILED, BERT_ENTRY_STEPS = (
    100, (10, 100), 10, 20)
#: vit: batch a card (the JAX default), steps, the timed window, steps
#: profiled after it, synthetic images made for the phase, the entry
#: point's steps and images in a child
VIT_BATCH, VIT_STEPS, VIT_TIMED, VIT_PROFILED = 256, 50, (10, 50), 10
VIT_EXAMPLES, VIT_ENTRY_STEPS, VIT_ENTRY_EXAMPLES = 1024, 10, 512
#: encoder parity, card (fp32, TF32 off) against the CPU on the same
#: weights and batches, three AdamW steps: the losses (relative) and the
#: final parameters as one vector (relative Frobenius): Adam turns the
#: key bias's rounding-noise gradient into a step of ~lr whose sign is
#: the noise's, so that tensor alone is not comparable relatively
ENC_TOL = {"loss": 1e-5, "params": 1e-4}


def _kernels_at(fa, dev, label, shape, kv=None, causal=False, window=None,
                scale=None, cap=None, backward=True):
    """The three bf16 kernels against their plain versions at a model's
    attention shape ([B, S, H, D] queries, `kv` KV heads, unmasked but
    for the causal band; `scale` and the logit `cap` as the model sets
    them): the forward's out and lse, the backward pair's dq, dk and dv
    (`_check_backward`; with `backward` False the forward only); then each
    kernel's time beside the plain version's, SDPA's (timing only; the
    band as a boolean mask, GQA through `enable_gqa`; SDPA has no logit
    cap) and its bound. Returns {kernel: {max_abs_err, ms, plain_ms,
    library_ms, bound_ms, bound_by}}."""
    import torch.nn.functional as F

    b, s, h, d = shape
    kv = kv or h
    dtype = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    opts = (causal, window, scale, cap)
    out, lse = fa.flash_forward(q, k, v, *opts)
    torch.cuda.synchronize(dev)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, *opts)
    out_rel = _rel(out.float(), ref_out.float())
    lse_err = float((lse - ref_lse).abs().max())
    max_abs = float((out.float() - ref_out.float()).abs().max())
    tol_out, tol_lse = TOL[dtype]
    ok = (bool(torch.isfinite(out).all()) and out_rel <= tol_out
          and lse_err <= tol_lse)
    what = (f"B={b} S={s} H={h} KV={kv} D={d} bf16 "
            f"{'causal' if causal else 'non-causal'} window={window} "
            f"scale={scale} cap={cap}")
    print(f"kernel flash_fwd {label}: {what}: out rel {out_rel:.3e} (tol "
          f"{tol_out:g}), lse max abs {lse_err:.3e} (tol {tol_lse:g}), out "
          f"max abs {max_abs:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"at the {label} shape")
    del ref_out, ref_lse
    res = {"flash_fwd": {"max_abs_err": max_abs}}
    res["flash_fwd"]["ms"] = _time_ms(lambda: fa.flash_forward(q, k, v,
                                                               *opts), dev)
    res["flash_fwd"]["plain_ms"] = _time_ms(
        lambda: fa.flash_forward_reference(q, k, v, *opts), dev, iters=3)
    if backward:
        do, out, lse, dq_err, dkv_err = _check_backward(
            fa, label, q, k, v, *opts, gen)
        delta = fa._delta(out, do)
        res["flash_bwd_dkv"] = {"max_abs_err": dkv_err}
        res["flash_bwd_dq"] = {"max_abs_err": dq_err}
        res["flash_bwd_dkv"]["ms"] = _time_ms(
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, *opts), dev)
        res["flash_bwd_dq"]["ms"] = _time_ms(
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, *opts), dev)
        plain_bwd = _time_ms(lambda: fa.flash_backward_reference(
            q, k, v, out, lse, do, *opts), dev, iters=3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa = {} if scale is None else {"scale": scale}
    if window is not None and window < s:
        rows = torch.arange(s, device=dev)[:, None]
        ago = rows - torch.arange(s, device=dev)[None, :]
        sdpa["attn_mask"] = (ago >= 0) & (ago < window)
    elif causal:
        sdpa["is_causal"] = True
    if kv != h:
        sdpa["enable_gqa"] = True
    res["flash_fwd"]["library_ms"] = _time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa), dev)
    if backward:
        ref = F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
        sdpa_bwd = _time_ms(lambda: torch.autograd.grad(
            ref, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), dev)
    for name, kernel in (("flash_fwd", "fwd"), ("flash_bwd_dkv", "dkv"),
                         ("flash_bwd_dq", "dq")):
        if name not in res:
            continue
        r = res[name]
        r["bound_ms"], r["bound_by"] = _bound(b, s, h, kv, d, dtype, causal,
                                              window, kernel)
        if kernel != "fwd":
            r["plain_ms"], r["library_ms"] = plain_bwd, sdpa_bwd
        print(f"kernel {name} {label} timing: kernel_ms {r['ms']:.4f}, "
              f"plain_ms {r['plain_ms']:.4f}"
              f"{'' if kernel == 'fwd' else ' (whole plain backward)'}, "
              f"library_ms {r['library_ms']:.4f} (SDPA "
              f"{'forward' if kernel == 'fwd' else 'backward, whole'}), "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    return res


def _encoder_compare(what, card, cpu):
    """Hold a card run of `testing.train_bert`/`train_vit` to the CPU run:
    every step's loss and the final parameters as one vector (ENC_TOL)."""
    loss = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
               for a, b in zip(card["history"], cpu["history"], strict=True))
    want = cpu["state_dict"]
    got = card["state_dict"]
    vec = _rel(torch.cat([torch.as_tensor(got[k]).flatten() for k in want]),
               torch.cat([torch.as_tensor(v).flatten()
                          for v in want.values()]))
    rounded = [[round(h["loss"], 6) for h in run["history"]]
               for run in (card, cpu)]
    print(f"{what}: losses card {rounded[0]} vs CPU {rounded[1]} (worst "
          f"rel {loss:.3e}, tol {ENC_TOL['loss']:g}); final parameters as "
          f"one vector rel {vec:.3e} (tol {ENC_TOL['params']:g})")
    if not (loss <= ENC_TOL["loss"] and vec <= ENC_TOL["params"]):
        raise AssertionError(f"{what}: the card disagrees with the CPU")


def _bert_parity(dev):
    """bert_tiny_test (fp32, dropout 0, TF32 off) takes three
    make_custom_train_step steps of bert_mlm.mlm_loss_fn on the same
    weights and masked batches: on the card under
    MultiWorkerMirroredStrategy (DDP on a one-rank NCCL group) and on the
    CPU with no strategy."""
    import torch.distributed as dist

    from tfde_tpu_torch import testing
    from tfde_tpu_torch.data.datasets import synthetic_tokens
    from tfde_tpu_torch.data.mlm import MlmConfig, mask_tokens
    from tfde_tpu_torch.models.bert import bert_tiny_test

    rng = np.random.default_rng(0)
    sd = {k: v.numpy().copy() for k, v in
          bert_tiny_test(device="cpu", seed=1).state_dict().items()}
    tokens = synthetic_tokens(64, 32, vocab=96)
    cfg = MlmConfig(vocab_size=96, mask_id=96)
    batches = [mask_tokens(tokens[rng.integers(0, 64, 16)], cfg, rng)
               for _ in range(3)]
    cpu = testing.train_bert(sd, batches, (1e-3, 1, 3), distributed=False)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        card = testing.train_bert(sd, batches, (1e-3, 1, 3), device=dev)
    finally:
        dist.destroy_process_group()
    _encoder_compare("bert parity: bert_tiny_test, three custom MLM steps "
                     "(masked AdamW) as DDP on a one-rank NCCL group vs the "
                     "CPU", card, cpu)


def _bert_recipe(fa, dev):
    """BertBase at the published widths through `bert_mlm.main` (the
    custom step under MultiWorkerMirroredStrategy, DDP on a one-rank NCCL
    group), BERT_STEPS + BERT_PROFILED steps of 64 x 128 tokens: ms a step
    over the BERT_TIMED window, tokens/s, memory, the losses, the flash
    launches a step (counters zeroed just before, read just after), and a
    torch.profiler window over the last BERT_PROFILED steps."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from tfde_tpu_torch import bert_mlm
    from tfde_tpu_torch.testing import profile_summary

    n = BERT_STEPS + BERT_PROFILED
    kept, clock = [], {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    real = bert_mlm.make_custom_train_step

    def mark(key):
        torch.cuda.synchronize(dev)
        clock[key] = time.perf_counter()

    def recording(*args, **kwargs):
        step_fn = real(*args, **kwargs)

        def step(state, batch, generator=None):
            if state.step in BERT_TIMED:
                mark(state.step)
            if state.step == BERT_STEPS:
                prof.start()
            state, metrics = step_fn(state, batch, generator)
            kept.append(metrics["loss"])
            if state.step == n:
                mark(n)
                prof.stop()
            return state, metrics

        return step

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    bert_mlm.make_custom_train_step = recording
    try:
        _zero_counts(fa)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, _ = bert_mlm.main(["--max-steps", str(n), "--device", "cuda"])
        wall = time.perf_counter() - t0
        launches = _counts(fa)
        params = sum(p.numel() for p in state.model.parameters())
    finally:
        bert_mlm.make_custom_train_step = real
        dist.destroy_process_group()
    losses = [float(x) for x in kept]
    ms = ((clock[BERT_TIMED[1]] - clock[BERT_TIMED[0]]) * 1e3
          / (BERT_TIMED[1] - BERT_TIMED[0]))
    mem = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    summary = profile_summary(prof, BERT_PROFILED,
                              (clock[n] - clock[BERT_STEPS]) * 1e3
                              / BERT_PROFILED)
    tokens = 64 * 128
    print(f"bert recipe: BertBase ({params:,} parameters, post-LN, bf16 "
          f"compute, fp32 master weights, dropout 0.1), seed 0, "
          f"bert_mlm.main --max-steps {n} (batch 64 x 128 tokens, masked "
          f"AdamW wd 0.01, lr 1e-4, warmup 100 + cosine) under "
          f"MultiWorkerMirroredStrategy as DDP on a one-rank NCCL group: "
          f"{state.step} steps in {wall:.1f} s; loss at step 1 "
          f"{losses[0]:.4f}, step 10 {losses[9]:.4f}, step {BERT_STEPS} "
          f"{losses[BERT_STEPS - 1]:.4f}")
    print(f"bert recipe: {ms:.3f} ms per step (mean of steps "
          f"{BERT_TIMED[0] + 1}-{BERT_TIMED[1]}, host clock after a "
          f"synchronise), {tokens / ms * 1e3:.0f} tokens/s, max memory "
          f"allocated {mem:.2f} GiB; flash launches fwd/dkv/dq {launches} "
          f"over {n} steps = {sum(launches) / n:g} a step; on {_card()}")
    _print_profile(summary, BERT_PROFILED, ms, "bert")
    if not all(math.isfinite(x) for x in losses) or len(losses) != n:
        raise AssertionError(f"non-finite or missing losses: {losses}")
    if not losses[BERT_STEPS - 1] < losses[0]:
        raise AssertionError(f"the BERT loss did not fall: {losses}")
    if launches != (12 * n,) * 3:
        raise AssertionError(f"BERT's attention did not launch each flash "
                             f"kernel 12 times a step: {launches}")
    return {"ms": ms, "launches": launches, "steps": n}


def phase_bert(fa, dev):
    """BERT-base MLM on the card (docstring, phase 12); its entry point's
    child is queued (`_entry_child`)."""
    kernels = _kernels_at(fa, dev, "bert", BERT_SHAPE)
    _bert_parity(dev)
    recipe = _bert_recipe(fa, dev)
    _entry_child(["tfde_tpu_torch.bert_mlm", "--max-steps",
                  str(BERT_ENTRY_STEPS)], "bert_mlm", BERT_ENTRY_STEPS)
    return kernels, recipe


def _vit_batches():
    rng = np.random.default_rng(0)
    images = rng.random((48, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, (48, 1)).astype(np.int64)
    return [(images[i * 16:(i + 1) * 16], labels[i * 16:(i + 1) * 16])
            for i in range(3)]


def _vit_parity(dev):
    """vit_tiny_test (fp32, TF32 off) takes three make_train_step steps
    (masked AdamW, wd 0.05) on the same weights and batches: on the card
    under FSDPStrategy (FSDP2 on a one-rank NCCL group) and on the CPU
    (no group: the model unsharded)."""
    import torch.distributed as dist

    from tfde_tpu_torch import testing
    from tfde_tpu_torch.models.vit import vit_tiny_test

    sd = {k: v.numpy().copy() for k, v in
          vit_tiny_test(device="cpu", seed=1).state_dict().items()}
    args = ({}, sd, _vit_batches(), (1e-3, 1, 3), 0.05)
    cpu = testing.train_vit(*args)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        card = testing.train_vit(*args, device=dev)
    finally:
        dist.destroy_process_group()
    _encoder_compare("vit parity: vit_tiny_test, three AdamW steps under "
                     "FSDPStrategy (FSDP2 on a one-rank NCCL group) vs the "
                     "CPU", card, cpu)
    return sd, args, cpu


def _vit_recipe(fa, dev):
    """ViT_B16 (224 px, 1000 classes, dropout 0.1, bf16 compute, fp32
    master weights, seed 0) from imagenet_vit.make_train_dataset(VIT_BATCH,
    use_native=True) through Estimator.train under FSDPStrategy (FSDP2 on
    a one-rank NCCL group), the entry point's optimizer and schedule at
    max_steps VIT_STEPS, then VIT_PROFILED more steps profiled: ms a step
    and images/s over the VIT_TIMED window, memory, the feed's blocking
    share, the losses, the flash launches a step (counters zeroed just
    before, read just after), the FSDP collectives a step and this rank's
    parameter and optimizer bytes."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile

    from tfde_tpu_torch import imagenet_vit
    from tfde_tpu_torch.data.pipeline import AutoShardPolicy
    from tfde_tpu_torch.models.vit import ViT_B16
    from tfde_tpu_torch.parallel.strategies import FSDPStrategy
    from tfde_tpu_torch.testing import profile_summary
    from tfde_tpu_torch.training import Estimator
    from tfde_tpu_torch.training.optimizers import (
        adamw, warmup_cosine_decay_schedule)
    from tfde_tpu_torch.training.step import make_train_step
    from tfde_tpu_torch.training.train_state import opt_state_bytes

    n = VIT_STEPS + VIT_PROFILED
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        model = ViT_B16(num_classes=1000, dropout_rate=0.1, device=dev,
                        seed=0)
        params = sum(p.numel() for p in model.parameters())
        warmup = min(100, max(VIT_STEPS - 1, 1))  # the entry point's
        tx = adamw(model, warmup_cosine_decay_schedule(0.0, 1e-3, warmup,
                                                       VIT_STEPS),
                   weight_decay=0.05)
        strategy = FSDPStrategy()
        est = Estimator(model, tx, strategy)
        step_fn = make_train_step(strategy, est._ensure_state())
        kept = []

        def recording(state, batch, generator):
            state, metrics = step_fn(state, batch, generator)
            kept.append(metrics["loss"])
            return state, metrics

        est._train_step = recording
        clock, wait = {}, {}
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

        def hook(state, step):
            if step in VIT_TIMED or step in (VIT_STEPS, n):
                torch.cuda.synchronize(dev)
                clock[step] = time.perf_counter()
                wait[step] = est.feed.wait_seconds
            if step == VIT_STEPS:
                prof.start()
            elif step == n:
                prof.stop()

        _zero_counts(fa)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        steps = est.train(
            lambda: imagenet_vit.make_train_dataset(
                VIT_BATCH, 224, VIT_EXAMPLES, 1000, use_native=True), n,
            AutoShardPolicy.OFF, _eval_hook=hook).step
        wall = time.perf_counter() - t0
        launches = _counts(fa)
        sharded = all(isinstance(p, DTensor) for p in model.parameters())
        param_bytes = sum((p.to_local() if isinstance(p, DTensor) else p)
                          .numel() * p.element_size()
                          for p in model.parameters())
        opt_bytes = opt_state_bytes(tx)
        est.close()
    finally:
        dist.destroy_process_group()
    losses = [float(x) for x in kept]
    window_s = clock[VIT_TIMED[1]] - clock[VIT_TIMED[0]]
    ms = window_s * 1e3 / (VIT_TIMED[1] - VIT_TIMED[0])
    blocked = wait[VIT_TIMED[1]] - wait[VIT_TIMED[0]]
    mem = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    summary = profile_summary(prof, VIT_PROFILED,
                              (clock[n] - clock[VIT_STEPS]) * 1e3
                              / VIT_PROFILED)
    collectives = {k: calls for k, _, calls in summary["host"]
                   if any(w in k.lower() for w in
                          ("all_gather", "allgather", "reduce_scatter",
                           "all_reduce", "allreduce"))}
    print(f"vit recipe: ViT_B16 ({params:,} parameters, 224 px, 1000 "
          f"classes, dropout 0.1, bf16 compute, fp32 master weights), seed "
          f"0, imagenet_vit.make_train_dataset({VIT_BATCH}, 224, "
          f"{VIT_EXAMPLES} synthetic images, use_native=True) -> "
          f"device_prefetch -> Estimator.train under {strategy.describe()} "
          f"(FSDP2 on a one-rank NCCL group; every parameter a DTensor: "
          f"{sharded}), masked AdamW wd 0.05, lr 1e-3, warmup {warmup} + "
          f"cosine to {VIT_STEPS}: {steps} steps in {wall:.1f} s; losses by "
          f"step { {i: round(losses[i - 1], 4) for i in (1, 10, 25, VIT_STEPS)
                   if i <= len(losses)} }")
    print(f"vit recipe: {ms:.3f} ms per step (mean of steps "
          f"{VIT_TIMED[0] + 1}-{VIT_TIMED[1]}, host clock after a "
          f"synchronise), {VIT_BATCH / ms * 1e3:.0f} images/s, max memory "
          f"allocated {mem:.2f} GiB, the feed's blocking share "
          f"{blocked / window_s:.4f}; flash launches fwd/dkv/dq {launches} "
          f"over {n} steps = {sum(launches) / n:g} a step; this rank holds "
          f"{param_bytes:,} parameter bytes and {opt_bytes:,} optimizer "
          f"bytes; FSDP collectives a step (profiled host ops) "
          f"{json.dumps(collectives)}; on {_card()}")
    _print_profile(summary, VIT_PROFILED, ms, "vit")
    head = sum(losses[:10]) / 10
    tail = sum(losses[VIT_STEPS - 10:VIT_STEPS]) / 10
    print(f"vit recipe: mean loss of steps 1-10 {head:.4f}, of steps "
          f"{VIT_STEPS - 9}-{VIT_STEPS} {tail:.4f}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != n:
        raise AssertionError(f"non-finite or missing losses: {losses}")
    if not tail < head:
        raise AssertionError(f"the ViT loss did not fall: {head} -> {tail}")
    if not sharded or launches != (12 * n,) * 3:
        raise AssertionError(f"ViT did not run sharded ({sharded}) or its "
                             f"attention did not launch each flash kernel "
                             f"12 times a step: {launches}")
    return {"ms": ms, "launches": launches, "steps": n}


def _vit_cards(parity):
    """Across every card of the machine, one process a card under
    FSDPStrategy on NCCL (`testing.fsdp_ranks_worker`): the parity run
    against the CPU, the same parameters on every rank after the gather,
    and each rank's parameter elements and optimizer bytes."""
    from tfde_tpu_torch.testing import fsdp_ranks_worker, run_ranks

    n = torch.cuda.device_count()
    if n < 2:
        print(f"vit cards: {n} card on this machine; FSDP across cards "
              f"needs two or more (not run)")
        return
    _, args, cpu = parity
    store = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", f"vit_store_{os.getpid()}")
    try:
        out = run_ranks(fsdp_ranks_worker, [(n, store, args)] * n,
                        timeout=600)
    finally:
        if os.path.exists(store):
            os.remove(store)
    for r, o in enumerate(out):
        if (o["backend"], o["device"]) != ("nccl", f"cuda:{r}"):
            raise AssertionError(f"rank {r} ran on {o['backend']}, "
                                 f"{o['device']}")
    same = all(np.array_equal(v, o["state_dict"][k]) for o in out[1:]
               for k, v in out[0]["state_dict"].items())
    total = sum(int(np.prod(v.shape)) for v in cpu["state_dict"].values())
    print(f"vit cards: FSDP over {n} cards: the same gathered parameters on "
          f"every rank: {same}; parameter elements a rank "
          f"{[sum(o['local_numel'].values()) for o in out]} of {total}; "
          f"optimizer bytes a rank {[o['opt_state_bytes'] for o in out]} "
          f"against {cpu['opt_state_bytes']} at one rank")
    _encoder_compare(f"vit cards: FSDP over {n} cards vs the CPU", out[0],
                     cpu)
    if not same:
        raise AssertionError("the ranks' gathered parameters differ")


def phase_vit(fa, dev):
    """ImageNet ViT-B/16 under FSDP on the card (docstring, phase 13); its
    entry point's child is queued (`_entry_child`)."""
    from tfde_tpu_torch.data import datasets

    load = datasets.imagenet
    try:
        kernels = _kernels_at(fa, dev, "vit", VIT_SHAPE)
        parity = _vit_parity(dev)
        t0 = time.perf_counter()
        arrays = load(n_train=VIT_EXAMPLES, n_test=1, side=224,
                      num_classes=1000)
        source = ("a local imagenet.npz" if datasets._find("imagenet.npz")
                  else "the synthetic stand-in")
        print(f"vit: ImageNet-shaped data ({VIT_EXAMPLES} training rows of "
              f"224 x 224 x 3, {source}) in {time.perf_counter() - t0:.1f} "
              f"s, made once for the phase")
        datasets.imagenet = lambda **kw: arrays
        recipe = _vit_recipe(fa, dev)
        datasets.imagenet = load
        _vit_cards(parity)
        _entry_child(["tfde_tpu_torch.imagenet_vit", "--max-steps",
                      str(VIT_ENTRY_STEPS), "--train-examples",
                      str(VIT_ENTRY_EXAMPLES)], "imagenet_vit",
                     VIT_ENTRY_STEPS)
    finally:
        datasets.imagenet = load
    return kernels, recipe


#: the gpt_lm phase: the slice's attention shape (GPT-2 small's 12 query
#: heads over 4 KV heads, the 256-token window), the steps of the train
#: run (then GL_PROFILED more under torch.profiler), of the packed run and
#: of the bert_mlm --remat run, and the flags the entry point runs with
GL_SHAPE, GL_KV, GL_WINDOW = (8, 1024, 12, 64), 4, 256
GL_STEPS, GL_PROFILED, GL_PACKED_STEPS, GL_BERT_STEPS = 20, 3, 10, 10
GL_ARGS = ["--seq-len", "1024", "--batch-size", "8", "--warmup-steps", "5",
           "--train-examples", "256", "--device", "cuda"]


def _gl_parity(fa, dev):
    """A small fp32 GPT with head dim 64, rope, 2 KV heads of 4, window
    24 and remat, the same weights on the card and on the CPU: prefill
    logits (the flash kernel on the card; the model served with remat off,
    `decode.remat_off`), the batcher's greedy tokens against CPU
    `generate`, then one next_token_loss + AdamW step (loss, every
    gradient, the updated parameters), the card's flash forward launched
    twice a layer (the remat recompute)."""
    from tfde_tpu_torch.inference.decode import generate, init_cache, remat_off
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.models.gpt import GPT, next_token_loss
    from tfde_tpu_torch.training.optimizers import adamw
    from tfde_tpu_torch.training.step import init_state

    cfg = dict(vocab_size=97, hidden_size=256, depth=2, num_heads=4,
               mlp_dim=512, max_position=64, dtype=torch.float32,
               position="rope", num_kv_heads=2, sliding_window=24,
               remat="full", seed=3)
    models = {"cuda": GPT(device=dev, **cfg), "cpu": GPT(device="cpu", **cfg)}
    models["cpu"].load_state_dict(
        {k: t.cpu() for k, t in models["cuda"].state_dict().items()})
    gpu, cpu = models["cuda"], models["cpu"]
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 97, (3, 40))
    _zero_counts(fa)
    with torch.no_grad(), remat_off(gpu), remat_off(cpu):
        got = gpu(torch.as_tensor(ids, device=dev),
                  cache=init_cache(gpu, 3, 48))
        want = cpu(torch.as_tensor(ids), cache=init_cache(cpu, 3, 48))
    rel = _rel(got.cpu(), want)
    launched = _counts(fa)
    print(f"gpt_lm parity: fp32 GPT(D=64, rope, 2 of 4 KV heads, window "
          f"24) prefill logits of 3 x 40 tokens, CUDA flash vs CPU plain: "
          f"rel {rel:.3e} (tol 1e-5), launches fwd/dkv/dq {launched}")
    if launched != (cfg["depth"], 0, 0) or not rel <= 1e-5:
        raise AssertionError("the rope/GQA/window prefill disagrees with "
                             "the CPU or did not run the flash kernel")
    srv = ContinuousBatcher(gpu, batch_size=2, max_len=48, scan_depth=4,
                            device=dev)
    prompts = [rng.integers(0, 97, p) for p in (5, 30, 3, 27)]
    rids = [srv.submit(p, 10) for p in prompts]
    done = dict(srv.run())
    same = 0
    for rid, p in zip(rids, prompts):
        toks, lens = generate(cpu, p[None, :], 10, device="cpu")
        same += int(np.array_equal(done[rid],
                                   toks[0, p.size:int(lens[0])].numpy()))
    print(f"gpt_lm parity: CUDA batcher greedy tokens == CPU generate for "
          f"{same}/{len(prompts)} requests (prompts of 5-30 tokens, window "
          f"24)")
    if same != len(prompts):
        raise AssertionError("CUDA batcher tokens differ from CPU generate")
    ids = rng.integers(0, 97, (4, 40))
    torch.cuda.synchronize(dev)
    _zero_counts(fa)
    got = {}
    for where, model in models.items():
        state = init_state(model, adamw(model, 1e-3, weight_decay=0.1))
        loss, _ = next_token_loss(model, torch.as_tensor(
            ids, device=model.device))
        loss.backward()
        grads = {n: p.grad.cpu().clone() for n, p in
                 model.named_parameters()}
        state.apply_gradients()
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        got[where] = (float(loss.detach()), grads, params)
    launched = _counts(fa)
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = got["cuda"], got["cpu"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = _grads_rel(g_gpu, g_cpu)
    param_rel = _rel(torch.cat([p_gpu[n].flatten() for n in p_cpu]),
                     torch.cat([p.flatten() for p in p_cpu.values()]))
    print(f"gpt_lm parity: one next_token_loss + AdamW step with remat "
          f"'full', CUDA kernels vs CPU plain: loss {l_gpu:.6f} vs "
          f"{l_cpu:.6f} (rel {loss_rel:.3e}, tol 1e-5), worst gradient rel "
          f"{grad_rel:.3e} (tol 1e-4), updated params rel {param_rel:.3e} "
          f"(tol 1e-4); launches fwd/dkv/dq {launched}")
    depth = cfg["depth"]
    if launched != (2 * depth, depth, depth):
        raise AssertionError("the remat train step did not run the flash "
                             "forward twice and the backward pair once a "
                             "layer")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and param_rel <= 1e-4):
        raise AssertionError("the remat train step disagrees with the CPU")


def _gl_entry(fa, dev, argv, label, history=None, minus=()):
    """`gpt_lm.main(argv)` with the launch counters zeroed just before and
    read just after, each step's loss and host time after a synchronise,
    and the share of real tokens in the packed batches, each printed.
    Each step's metrics (as floats) are appended to `history` when one is
    given. The series held finite and falling is each step's loss less
    its metrics named in `minus` (an MoE model's sown losses: what is
    left is the cross-entropy). Returns the final state, ms a step (mean
    of the steps after the second), the launches and the train step
    function."""
    from tfde_tpu_torch import gpt_lm

    losses, clock, fill, steps = [], [], [], []
    real = gpt_lm.make_custom_train_step

    def recording(*args, **kwargs):
        step_fn = real(*args, **kwargs)
        steps.append(step_fn)

        def step(state, batch, generator=None):
            state, metrics = step_fn(state, batch, generator)
            losses.append(metrics["loss"] - sum(
                metrics[k] for k in minus if k in metrics))
            if history is not None:
                history.append(metrics)
            if len(batch) == 2:
                fill.append(float((batch[1] > 0).float().mean()))
            torch.cuda.synchronize(dev)
            clock.append(time.perf_counter())
            return state, metrics

        return step

    gpt_lm.make_custom_train_step = recording
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts(fa)
        clock.append(time.perf_counter())
        state, _ = gpt_lm.main(argv)
        launches = _counts(fa)
    finally:
        gpt_lm.make_custom_train_step = real
    losses = [float(x) for x in losses]
    if history is not None:
        history[:] = [{k: float(v) for k, v in m.items()} for m in history]
    step_s = [b - a for a, b in zip(clock, clock[1:])]
    ms = sum(step_s[2:]) / len(step_s[2:]) * 1e3
    mem = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    share = sum(fill) / len(fill) if fill else None
    n = len(losses)
    print(f"{label}: gpt_lm.main {' '.join(argv)}: {n} steps; losses"
          f"{' less ' + ', '.join(minus) if minus else ''} "
          f"{[round(x, 4) for x in losses]}")
    print(f"{label}: {ms:.3f} ms per step (mean of steps 3-{n}, host clock "
          f"after a synchronise), first step {step_s[0] * 1e3:.1f} ms, "
          f"{GL_SHAPE[0] * GL_SHAPE[1] / ms * 1e3:.0f} tokens/s"
          + ("" if share is None else
             f" ({GL_SHAPE[0] * GL_SHAPE[1] * share / ms * 1e3:.0f} real "
             f"tokens/s at a fill "
             f"share of {share:.4f})")
          + f", max memory allocated {mem:.2f} GiB; flash launches "
          f"fwd/dkv/dq {launches}; on {_card()}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss is not finite and falling: "
                             f"{losses}")
    return state, ms, launches, steps[0]


def _gl_bert_remat(fa, dev):
    """`bert_mlm.main --remat` for GL_BERT_STEPS steps on a one-rank NCCL
    group: the flash forward runs twice a layer a step, the backward pair
    once."""
    import torch.distributed as dist

    from tfde_tpu_torch import bert_mlm

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts(fa)
        t0 = time.perf_counter()
        state, metrics = bert_mlm.main(["--max-steps", str(GL_BERT_STEPS),
                                        "--device", "cuda", "--remat"])
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        launches = _counts(fa)
    finally:
        dist.destroy_process_group()
    n = GL_BERT_STEPS
    mem = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"gpt_lm bert --remat: bert_mlm.main --max-steps {n} --remat "
          f"(BertBase, 64 x 128 tokens): {state.step} steps in {wall:.1f} s "
          f"(model build included), last loss {loss:.4f}, max memory "
          f"allocated {mem:.2f} GiB; flash launches fwd/dkv/dq {launches} = "
          f"{[x / n for x in launches]} a step")
    if launches != (24 * n, 12 * n, 12 * n) or not math.isfinite(loss):
        raise AssertionError(f"bert_mlm --remat did not launch the flash "
                             f"forward 24 times and the backward pair 12 "
                             f"times a step: {launches}")


#: gpt_lm --generate: GPT-2 small trained a few steps, then 32 tokens
#: greedy after a 16-token prompt of two rows, exported and served again
GL_GEN_STEPS, GL_GEN_TOKENS = 3, 32


def _gl_generate(fa, dev, root):
    """`gpt_lm.main([... "--generate", "32", "--export-generate", DIR,
    "--temperature", "0"])` at GPT-2 small's width: the in-process greedy
    tokens (one flash prefill: 12 launches beyond the training steps'),
    the export's seconds and bytes, then the artifact loaded in a fresh
    process on the card, which must give the same tokens for the same
    seed and launch the flash kernel once a layer in its prefill."""
    from tfde_tpu_torch import gpt_lm

    calls = {}
    real_generate, real_export = gpt_lm.generate, gpt_lm.export_generate

    def generate(model, prompt, n, **kw):
        calls["prompt"], calls["seed"] = np.asarray(prompt), kw["seed"]
        before = fa.flash_forward.launches
        out = real_generate(model, prompt, n, **kw)
        calls["tokens"] = out[0].cpu().numpy()
        calls["launches"] = fa.flash_forward.launches - before
        return out

    def export(*args, **kw):
        t0 = time.perf_counter()
        calls["dir"] = real_export(*args, **kw)
        calls["export_s"] = time.perf_counter() - t0
        return calls["dir"]

    gpt_lm.generate, gpt_lm.export_generate = generate, export
    try:
        gpt_lm.main(["--max-steps", str(GL_GEN_STEPS), "--generate",
                     str(GL_GEN_TOKENS), "--export-generate",
                     os.path.join(root, "generate"), "--temperature", "0",
                     *GL_ARGS])
    finally:
        gpt_lm.generate, gpt_lm.export_generate = real_generate, real_export
    served, child, child_s = _artifact_child(
        "generate", calls["dir"], calls["prompt"], root, calls["seed"])
    same = bool(np.array_equal(served, calls["tokens"]))
    print(f"gpt_lm generate: gpt_lm.main --generate {GL_GEN_TOKENS} "
          f"--export-generate --temperature 0 (GPT-2 small, "
          f"{GL_GEN_STEPS} steps): {calls['prompt'].shape[0]} prompts of "
          f"{calls['prompt'].shape[1]} tokens; in process {calls['launches']} "
          f"flash launches; the artifact exported in {calls['export_s']:.2f} "
          f"s ({_artifact_bytes(calls['dir']):,} bytes: prefill and tick "
          f"programs, params.npz), loaded and run in a fresh process on the "
          f"card in {child_s:.1f} s with {child['fwd']} flash launches; its "
          f"greedy tokens equal the in-process run's: {same}")
    depth = 12
    if calls["launches"] != depth or child["fwd"] != depth:
        raise AssertionError("the generate prefill did not launch the flash "
                             "kernel once a layer on both sides")
    if not same:
        raise AssertionError(f"the generative artifact's tokens "
                             f"{served.tolist()} differ from the in-process "
                             f"run's {calls['tokens'].tolist()}")


def phase_gpt_lm(fa, dev):
    """GPT pretraining with rope, GQA, the sliding window, remat and
    packing through `python -m tfde_tpu_torch.gpt_lm` (docstring, phase
    14)."""
    from tfde_tpu_torch.data.datasets import synthetic_tokens

    _gl_parity(fa, dev)
    argv = ["--rope", "--kv-heads", str(GL_KV), "--sliding-window",
            str(GL_WINDOW), "--remat", "--max-steps", str(GL_STEPS),
            *GL_ARGS]
    state, ms, launches, step_fn = _gl_entry(fa, dev, argv, "gpt_lm train")
    want = (24 * GL_STEPS, 12 * GL_STEPS, 12 * GL_STEPS)
    if launches != want:
        raise AssertionError(f"gpt_lm train: launches {launches}, not "
                             f"{want} (remat runs the flash forward twice "
                             f"a layer)")
    tokens = synthetic_tokens(256, 1024, vocab=state.model.vocab_size,
                              seed=2)
    nrng = np.random.default_rng(1)
    batches = [torch.as_tensor(tokens[nrng.integers(0, 256, 8)], device=dev)
               for _ in range(GL_PROFILED)]
    _profile_train(lambda x: step_fn(state, (x,))[1]["loss"], batches, dev,
                   ms, label="gpt_lm train")
    del state, step_fn, batches
    argv = ["--packed", "--rope", "--kv-heads", str(GL_KV), "--remat",
            "--max-steps", str(GL_PACKED_STEPS), *GL_ARGS]
    launches = _gl_entry(fa, dev, argv, "gpt_lm packed")[2]
    if launches != (0, 0, 0):
        raise AssertionError(f"gpt_lm packed: the segment mask must take "
                             f"the reference einsum, not the flash kernels: "
                             f"{launches}")
    kernels = _kernels_at(fa, dev, "gpt_lm", GL_SHAPE, kv=GL_KV, causal=True,
                          window=GL_WINDOW)
    _gl_bert_remat(fa, dev)
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"gpt_lm_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        _gl_generate(fa, dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return kernels


#: hf_serve: the tolerances of the small-width parity — fp32 card logits
#: (the fp32 kernel: the same sums in another order) and bf16 card logits
#: (every GEMM output and the kernel's P rounded to bf16; 0.0067-0.0096
#: measured for these configs in bf16 on the CPU) against fp32 CPU logits
HF_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
#: hf_serve at full width: the first-token logits of one wave, flash
#: against the reference einsum in fp32 (the same sums in another order),
#: and in bf16 each path against the fp32 einsum on the same weights,
#: flash held to this multiple of the bf16 einsum's own error. bf16 cannot be held to a
#: fixed bound there: its rounding grows with depth (flash vs einsum
#: 1.16e-2 at GPT-2 small's 12 layers, 2.88e-2 at Llama-3.2-1B's 16)
HF_WAVE_TOL, HF_BF16_RATIO = 1e-4, 2.0
#: new tokens of every hf_serve request (cut from 32, then 16, to keep
#: the whole script inside its time limit beside the decoding and moe
#: phases)
HF_NEW = 8
#: the two prefill shapes of the full-width models, [B, S, H, D] and KV
#: heads (Llama-3.2-1B, Qwen3-0.6B)
HF_PREFILL = {"Llama-3.2-1B": ((1, 4096, 32, 64), 8),
              "Qwen3-0.6B": ((1, 4096, 16, 128), 8)}


def _hf_parity(fa, dev, root):
    """One small GPT per field group (`testing.FIELD_GROUPS`, random
    weights from seed 0) through `save_converted` -> `load_converted`: its
    prefill logits on the card (flash, fp32 and bf16) against the same
    artifact in fp32 on the CPU (plain attention), and the card's batcher
    greedy tokens (fp32) against CPU `generate`."""
    from tfde_tpu_torch.inference.decode import generate, init_cache
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.models.convert import load_converted, save_converted
    from tfde_tpu_torch.models.gpt import GPT
    from tfde_tpu_torch.testing import FIELD_GROUPS

    rng = np.random.default_rng(6)
    ids = rng.integers(0, 256, (3, 100))
    prompts = [rng.integers(0, 256, p) for p in (5, 37, 3, 20)]
    for group, (family, fields) in FIELD_GROUPS.items():
        out = save_converted(GPT(**fields, device=dev, seed=0),
                             os.path.join(root, group), family)
        cpu = load_converted(out, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            want = cpu(torch.as_tensor(ids), cache=init_cache(cpu, 3, 104))
        rels, cards = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            card = cards[dtype] = load_converted(out, dtype=dtype, device=dev)
            before = fa.flash_forward.launches
            with torch.no_grad():
                got = card(torch.as_tensor(ids, device=dev),
                           cache=init_cache(card, 3, 104))
            if fa.flash_forward.launches - before != card.depth:
                raise AssertionError(f"hf_serve {group}: the prefill did not "
                                     f"run the flash kernel once a layer")
            rels[dtype] = _rel(got.cpu(), want)
        srv = ContinuousBatcher(cards[torch.float32], batch_size=2,
                                max_len=64, scan_depth=4, device=dev)
        rids = [srv.submit(p, 12) for p in prompts]
        done = dict(srv.run())
        same = sum(int(np.array_equal(done[rid], generate(
            cpu, p[None], 12, device="cpu")[0][0, p.size:].numpy()))
            for rid, p in zip(rids, prompts))
        ok = (all(r <= HF_TOL[d] for d, r in rels.items())
              and same == len(prompts))
        print(f"hf_serve parity {group} ({family}, head dim "
              f"{cpu.head_dim}, {cpu.kv_heads} of {cpu.num_heads} KV "
              f"heads): prefill logits vs CPU fp32, card fp32 rel "
              f"{rels[torch.float32]:.3e} (tol {HF_TOL[torch.float32]:g}), "
              f"card bf16 rel {rels[torch.bfloat16]:.3e} (tol "
              f"{HF_TOL[torch.bfloat16]:g}); fp32 batcher == CPU generate "
              f"for {same}/{len(prompts)} requests -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"hf_serve parity failed for {group}")


def _hf_wave_logits(model, wave, dev) -> dict:
    """{impl: first-token logits} of one prefill wave of `wave` (padded to
    its power-of-two bucket, as the batcher pads it) with attn_impl flash
    and reference."""
    from tfde_tpu_torch.inference.decode import init_cache

    bucket = 1 << max(3, math.ceil(math.log2(max(p.size for p in wave))))
    batch = np.zeros((len(wave), bucket), np.int64)
    for i, p in enumerate(wave):
        batch[i, :p.size] = p
    last = torch.as_tensor([p.size - 1 for p in wave], device=dev)
    rows = torch.arange(len(wave), device=dev)
    logits = {}
    with torch.no_grad():
        for impl in ("flash", "reference"):
            model.set_attn_impl(impl)
            h = model.hidden(torch.as_tensor(batch, device=dev),
                             cache=init_cache(model, len(wave), bucket))
            logits[impl] = model.head(h[rows, last])
    model.set_attn_impl("auto")
    return logits


def _hf_full(fa, dev, root, name, artifact=True):
    """A full-width model from its published config (random weights from
    seed 0, fp32 master weights) written with `save_converted`, served by
    `serve_gpt.main(["--hf-dir", ...])`, then loaded again and served in
    bf16 through a ContinuousBatcher as in `phase_serve`; then the same
    weights computed in fp32 for the held flash-vs-einsum logits and
    greedy tokens. With `artifact` False the model is built on the card
    and served as it is: no artifact round trip. Returns the batcher's
    flash launches at the kernel's head dim."""
    import gc
    import shutil

    from tfde_tpu_torch import serve_gpt
    from tfde_tpu_torch.inference.decode import generate
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.models.convert import load_converted, save_converted
    from tfde_tpu_torch.models.gpt import GPT
    from tfde_tpu_torch.testing import FULL_WIDTH

    family, fields = FULL_WIDTH[name]
    out = os.path.join(root, name)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = GPT(**fields, device=dev, seed=0)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if artifact:
        t0 = time.perf_counter()
        save_converted(model, out, family)
        write_s = time.perf_counter() - t0
        del model
        gc.collect()
        torch.cuda.empty_cache()
        nbytes = os.path.getsize(os.path.join(out, "params.npz"))
        t0 = time.perf_counter()
        done = serve_gpt.main(["--hf-dir", out, "--requests", "16",
                               "--batch-size", "8", "--max-len", "1024",
                               "--max-new-tokens", str(HF_NEW)])
        torch.cuda.synchronize(dev)
        entry_s = time.perf_counter() - t0
        if len(done) != 16 or any(len(t) != HF_NEW for _, t in done):
            raise AssertionError(f"hf_serve {name}: serve_gpt --hf-dir did "
                                 f"not answer 16 requests of {HF_NEW} tokens")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model = load_converted(out, device=dev).cast_compute_weights_()
        torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t0
        print(f"hf_serve {name}: {n_params:,} parameters; artifact "
              f"{nbytes / 1e9:.3f} GB written in {write_s:.2f} s, loaded "
              f"onto the card (fp32, then cast to bf16) in {load_s:.2f} s; "
              f"serve_gpt.main --hf-dir (load + 16 requests of 2-8 prompt "
              f"tokens x {HF_NEW}) {entry_s:.2f} s")
    else:
        model.cast_compute_weights_()
        torch.cuda.synchronize(dev)
        print(f"hf_serve {name}: {n_params:,} parameters, built on the card "
              f"(fp32 master weights from seed 0) in {build_s:.2f} s and cast "
              f"to bf16; the artifact round trip is skipped for this model "
              f"(save_converted and serve_gpt --hf-dir are held on "
              f"Qwen3-0.6B; its fp32 artifact would be "
              f"{4 * n_params / 1e9:.1f} GB)")

    srv = ContinuousBatcher(model, batch_size=8, max_len=1024, scan_depth=4,
                            device=dev)
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 961, 16)
    prompts = [rng.integers(0, model.vocab_size, int(p)) for p in plens]
    torch.cuda.synchronize(dev)
    _zero_counts(fa)
    t0 = time.perf_counter()
    rids = [srv.submit(p, HF_NEW) for p in prompts]
    done = dict(srv.run())
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = fa.flash_forward.launches
    at_head_dim = fa.flash_forward.by_head_dim[
        fa.kernel_head_dim(model.head_dim)]
    stats = srv.stats()
    ttft = srv.ttft_ms()
    n_tok = sum(len(t) for t in done.values())
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    mean_ttft = sum(ttft.values()) / max(len(ttft), 1)
    print(f"hf_serve {name}: bf16, batch 8, max_len 1024, scan depth 4: "
          f"{len(done)}/16 requests, {n_tok} tokens in {dt:.3f} s "
          f"({n_tok / dt:.1f} tok/s), mean TTFT {mean_ttft:.1f} ms, "
          f"{dt * 1e3 / n_tok:.2f} ms per output token, peak "
          f"{peak:.2f} GiB; prompt lengths {[int(p) for p in plens]}")
    print(f"hf_serve {name}: stats {json.dumps(stats)}")
    print(f"hf_serve {name}: flash_fwd launches {launches} ({at_head_dim} "
          f"at head dim {model.head_dim}) over {stats['prefill_waves']} "
          f"prefill waves x {model.depth} layers")
    if sorted(done) != sorted(rids):
        raise AssertionError(f"hf_serve {name}: not every request finished")
    for rid, toks in done.items():
        if (len(toks) != HF_NEW or toks.min() < 0
                or toks.max() >= model.vocab_size):
            raise AssertionError(f"hf_serve {name}: request {rid} returned "
                                 f"{toks!r}")
    if not (launches > 0 and at_head_dim == launches
            and launches == model.depth * stats["prefill_waves"]):
        raise AssertionError(f"hf_serve {name}: the batcher did not run the "
                             f"flash kernel once a layer a prefill wave")

    # one wave's first-token logits, flash vs the reference einsum, in the
    # served bf16 here and in fp32 below
    bf16 = _hf_wave_logits(model, prompts[:4], dev)
    # bf16 greedy decoding is not batch-invariant (cuBLAS picks other
    # reduction orders for the batcher's 8-row GEMMs than for generate's
    # one row, and a one-ulp change flips a near-tie): counted here, held
    # exactly in fp32 below
    bf16_same = sum(int(np.array_equal(done[rid], generate(
        model, p[None], HF_NEW, device=dev)[0][0, p.size:].cpu().numpy()))
        for rid, p in zip(rids[:4], prompts[:4]))
    # the same (bf16-valued) weights computed in fp32: no second load
    model32 = GPT(**model.config, dtype=torch.float32, device=dev)
    model32.load_state_dict(model.state_dict())
    del model, srv
    gc.collect()
    torch.cuda.empty_cache()
    model = model32
    fp32 = _hf_wave_logits(model, prompts[:4], dev)
    rel32 = _rel(fp32["flash"], fp32["reference"])
    rel16 = _rel(bf16["flash"], bf16["reference"])
    err = {impl: _rel(bf16[impl], fp32["reference"]) for impl in bf16}
    finite = all(bool(torch.isfinite(t).all())
                 for t in (*bf16.values(), *fp32.values()))
    print(f"hf_serve {name}: first-token logits of a 4-prompt wave, flash "
          f"vs the reference einsum: fp32 rel {rel32:.3e} (tol "
          f"{HF_WAVE_TOL:g}); bf16 rel {rel16:.3e}, "
          f"each bf16 path against the fp32 einsum: flash "
          f"{err['flash']:.3e}, einsum {err['reference']:.3e} (flash held "
          f"to {HF_BF16_RATIO:g}x the einsum's); finite {finite}")
    if not (finite and rel32 <= HF_WAVE_TOL
            and err["flash"] <= HF_BF16_RATIO * err["reference"]):
        raise AssertionError(f"hf_serve {name}: flash and reference prefill "
                             f"logits disagree")
    srv = ContinuousBatcher(model, batch_size=8, max_len=1024, scan_depth=4,
                            device=dev)
    rids32 = [srv.submit(p, HF_NEW) for p in prompts[:4]]
    done32 = dict(srv.run())
    same = sum(int(np.array_equal(done32[rid], generate(
        model, p[None], HF_NEW, device=dev)[0][0, p.size:].cpu().numpy()))
        for rid, p in zip(rids32, prompts[:4]))
    print(f"hf_serve {name}: the first four requests' greedy tokens, batcher "
          f"== generate on the card: fp32 {same}/4 (held), bf16 "
          f"{bf16_same}/4 (counted)")
    if same != 4:
        raise AssertionError(f"hf_serve {name}: the batcher's greedy tokens "
                             f"differ from generate's")
    del model, srv
    shutil.rmtree(out, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return at_head_dim


def _hf_prefill_kernels(fa, dev, shapes=None):
    """The forward kernel at full-width prefill shapes (`shapes`, by
    default `HF_PREFILL`'s two; bf16, causal): against its plain version,
    then three timed calls beside the plain version, SDPA (`enable_gqa`;
    timing only) and the bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(7)
    for name, ((b, s, h, d), kv) in (shapes or HF_PREFILL).items():
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        out, lse = fa.flash_forward(q, k, v, True)
        torch.cuda.synchronize(dev)
        ref_out, ref_lse = fa.flash_forward_reference(q, k, v, True)
        out_rel = _rel(out.float(), ref_out.float())
        lse_err = float((lse - ref_lse).abs().max())
        tol_out, tol_lse = TOL[torch.bfloat16]
        del ref_out, ref_lse
        if not (bool(torch.isfinite(out).all()) and out_rel <= tol_out
                and lse_err <= tol_lse):
            raise AssertionError(f"flash_fwd disagrees with its plain version "
                                 f"at the {name} prefill shape")
        ms = [_time_ms(lambda: fa.flash_forward(q, k, v, True), dev)
              for _ in range(3)]
        plain = _time_ms(lambda: fa.flash_forward_reference(q, k, v, True),
                         dev, iters=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), dev)
        bound, by = _bound(b, s, h, kv, d, torch.bfloat16, True, None)
        print(f"kernel flash_fwd {name} prefill [{b}, {s}, {h} -> {kv} KV "
              f"heads, {d}] bf16 causal: out rel {out_rel:.3e}, lse max abs "
              f"{lse_err:.3e}; kernel_ms {', '.join(f'{t:.4f}' for t in ms)}, "
              f"plain_ms {plain:.4f}, library_ms (SDPA, enable_gqa) "
              f"{sdpa:.4f}, bound_ms {bound:.4f} ({by})")


def phase_hf_serve(fa, dev):
    """Converted checkpoints served on the card (docstring, phase 15).
    Every artifact lies under build/ and is removed at the end."""
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"hf_serve_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    try:
        _hf_parity(fa, dev, root)
        _hf_full(fa, dev, root, "Llama-3.2-1B", artifact=False)
        _hf_full(fa, dev, root, "Qwen3-0.6B")
        gemma = _hf_full(fa, dev, root, "Gemma-2-2B", artifact=False)
        _hf_prefill_kernels(fa, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return gemma


#: prefix_paged: Llama-3.2-1B at its published widths behind the batcher
#: (batch 8, max_len 1024, scan depth 4), 24 requests x PP_NEW new tokens
#: (32 until PR 17: cut to keep the whole script inside its time limit
#: beside the decoding phase), each
#: a shared 512-token system prompt from seed 0 + a suffix of 16-256
#: tokens; requests 8, 13, 18 and 23 repeat the whole prompt of requests
#: 0, 2, 4 and 6
PP_BATCH, PP_MAX_LEN, PP_DEPTH, PP_NEW = 8, 1024, 4, 16
PP_SYSTEM, PP_SUFFIX, PP_REQUESTS = 512, (16, 256), 24
PP_REPEATS = {8: 0, 13: 2, 18: 4, 23: 6}
#: run (d)'s pool: two max-length rows and the null block (nmax =
#: ceil(1025 / 16) = 65), and the defrag threshold of that run alone. Its
#: trie holds at most PP_TRIE_BLOCKS blocks (the system prompt's 32 + 8):
#: under the capacity gate (a request's whole lifetime against the free
#: blocks plus the trie's childless leaves) the allocations of this
#: traffic never starve, so only the budget makes the trie evict
PP_SMALL_POOL, PP_DEFRAG, PP_TRIE_BLOCKS = 2 * 65 + 1, "0.1", 40
#: each row's paged table gathered into position order against run (b)'s
#: dense cache over its committed cells, fp32, relative norm, each layer:
#: the two runs compute the same K/V through other programs (a cold wave
#: of [8, 1024] on the flash kernel against [8, 64] chunks on the einsum),
#: and fp32 rounding across Llama-3.2-1B's 16 layers reaches 8.8e-6 (my
#: chip run, PR 14; 7.8e-6 between flash and the einsum on its logits, PR
#: 12); a wrong block is off by O(1)
PP_GATHER_TOL = 1e-4
#: int8 KV. JAX's acceptance of an int8 run is a greedy match >= 0.98
#: against fp (tests/test_kv_quant.py `_match_rate`), on its tiny CPU
#: model, where the int8 logit error (~0.01) is below the top-2 margins.
#: Llama-3.2-1B's random weights give near-flat logits: where the runs
#: part, the fp twin's top-2 margin is 5e-3-3e-2 and the int8 logit error
#: (max over the 128,256 logits) 0.09-0.12, so 0.37 of the fp32 tokens
#: matched (NVIDIA H100 80GB HBM3, 700 W). The rate is printed, not
#: held; each fp32 request is held instead to part from its twin only
#: where the int8 function explains it, at the first differing step, on
#: the twin's tokens: the twin's top-2 margin is at most twice the int8
#: logit error
#: (+ PP_FLIP_SLACK for the batched programs' fp32 rounding), and the
#: int8 run took the int8 function's top token (the sequence prefilled
#: into an int8 cache), unless that function's own top-2 margin is below
#: PP_FLIP_SLACK x 10 (a tie, counted).
PP_MATCH_FLOOR = 0.98
PP_FLIP_SLACK = 1e-4
#: the headroom budget of the idle batchers: two fp32 max-length rows of
#: Llama-3.2-1B (16 layers x 8 KV heads x D 64: 65,536 bytes a cell in
#: fp32, 17,408 in int8)
PP_BUDGET = 134_217_728


def _pp_prompts(vocab: int) -> list:
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, PP_SYSTEM)
    prompts = []
    for i in range(PP_REQUESTS):
        if i in PP_REPEATS:
            prompts.append(prompts[PP_REPEATS[i]].copy())
            continue
        n = int(rng.integers(PP_SUFFIX[0], PP_SUFFIX[1] + 1))
        prompts.append(np.concatenate([system, rng.integers(0, vocab, n)]))
    return prompts


def _pp_run(fa, dev, model, prompts, label, at_warm=None, keep_layer0=False,
            **kw):
    """Serve `prompts` x PP_NEW through ContinuousBatcher(**kw), the launch
    counters zeroed just before and read just after. `at_warm(srv, step)`
    runs once, after the first step that admitted a request from the
    prefix cache; the ledger's used bytes are held against the live cells'
    bytes once, after the first step with every row busy (with a prefix
    cache: with a warm row); the seconds of both are left out of the
    run's. `keep_layer0` keeps copies of layer 0's cache planes at the
    end and the last request of each row. Prints the run's measurements
    and returns them with the tokens."""
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.testing import live_kv_bytes

    srv = ContinuousBatcher(model, batch_size=PP_BATCH, max_len=PP_MAX_LEN,
                            scan_depth=PP_DEPTH, device=dev, **kw)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts(fa)
    t0 = time.perf_counter()
    rids = [srv.submit(p, PP_NEW) for p in prompts]
    done, steps, paused, ledger, last = {}, 0, 0.0, None, {}
    while not srv.idle:
        done.update(srv.step())
        steps += 1
        last.update((r, rid) for r, rid in enumerate(srv._req)
                    if rid is not None)
        if at_warm is not None and any(srv.reused_tokens().values()):
            tp = time.perf_counter()
            at_warm(srv, steps)
            at_warm = None
            paused += time.perf_counter() - tp
        if ledger is None and (
                srv.free_rows == 0 if srv.prefix_cache is None
                else any(srv.reused_tokens().get(rid) for rid in srv._req)):
            tp = time.perf_counter()
            torch.cuda.synchronize(dev)
            kv = srv.kv_stats()
            ledger = (steps, kv["used_bytes"], live_kv_bytes(srv))
            paused += time.perf_counter() - tp
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0 - paused
    launches = fa.flash_forward.launches
    if sorted(done) != sorted(rids):
        raise AssertionError(f"prefix_paged {label}: not every request "
                             f"finished")
    tokens = [done[r] for r in rids]
    for rid, toks in zip(rids, tokens):
        if (len(toks) != PP_NEW or toks.min() < 0
                or toks.max() >= model.vocab_size):
            raise AssertionError(f"prefix_paged {label}: request {rid} "
                                 f"returned {toks!r}")
    stats, waves = srv.stats(), srv.wave_counts()
    ttft, reused, queue = srv.ttft_ms(), srv.reused_tokens(), srv.queue_ms()
    warm = [r for r in rids if reused[r] > 0]
    cold = [r for r in rids if reused[r] == 0]
    n_tok = sum(len(t) for t in tokens)
    trie = (srv.prefix_cache.stats() if srv.prefix_cache is not None
            else None)
    pool = srv.block_pool.stats() if srv.block_pool is not None else None

    def mean(ms, rs, less=None):
        if not rs:
            return float("nan")
        return sum(ms[r] - (less[r] if less else 0.0) for r in rs) / len(rs)

    out = dict(tokens=tokens, launches=launches, waves=waves, trie=trie,
               warm=warm, reused=reused, defrags=srv.defrag_passes,
               stalls=srv.capacity_stalls, pool=pool, tok_s=n_tok / dt,
               ms_token=dt * 1e3 / n_tok, ttft_cold=mean(ttft, cold),
               ttft_warm=mean(ttft, warm),
               wave_cold=mean(ttft, cold, queue),
               wave_warm=mean(ttft, warm, queue), stats=stats,
               tick_ms=stats["decode_s"] * 1e3 / max(stats["rounds"], 1),
               peak=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               kv=srv.kv_stats(), ledger=ledger,
               blocks=(srv.block_pool.num_blocks
                       if srv.block_pool is not None else None))
    if keep_layer0:
        out["layer0"] = {name: t.clone() for (layer, name), t
                         in srv._cache.planes().items() if layer == 0}
        out["rows_last"] = {r: rids.index(rid) for r, rid in last.items()}
    print(f"prefix_paged {label}: {len(done)}/{len(rids)} requests, {n_tok} "
          f"tokens in {dt:.3f} s ({out['tok_s']:.1f} tok/s), "
          f"{out['ms_token']:.2f} ms per output token; mean TTFT cold "
          f"{out['ttft_cold']:.1f} ms ({len(cold)} requests), warm "
          f"{out['ttft_warm']:.1f} ms ({len(warm)}), of which in the "
          f"admission wave (after the queue) cold {out['wave_cold']:.1f}, "
          f"warm {out['wave_warm']:.1f} ms; prefill "
          f"{stats['prefill_s']:.3f} s over {stats['prefill_waves']} waves "
          f"{json.dumps(waves)}, decode {stats['decode_s']:.3f} s over "
          f"{stats['rounds']} ticks ({out['tick_ms']:.2f} ms a tick); peak "
          f"{out['peak']:.2f} GiB")
    print(f"prefix_paged {label}: trie {json.dumps(trie)}; reused tokens a "
          f"warm request min {min((reused[r] for r in warm), default=0)}; "
          f"pool {json.dumps(pool)}, defrag passes {srv.defrag_passes}, "
          f"capacity stalls {srv.capacity_stalls}; flash_fwd launches "
          f"{launches} over {waves.get('cold', 0)} cold waves x {model.depth} "
          f"layers")
    print(f"prefix_paged {label}: kv_stats at the end {json.dumps(out['kv'])}")
    if ledger is None:
        raise AssertionError(f"prefix_paged {label}: no step had every row "
                             f"busy")
    step, used, live = ledger
    print(f"prefix_paged {label}: after step {step} kv/used_bytes {used:.0f} "
          f"vs the live cells' tensor bytes {live} (rel "
          f"{abs(used - live) / live:.2e}; held at 1%)")
    if not abs(used - live) <= 0.01 * live:
        raise AssertionError(f"prefix_paged {label}: kv/used_bytes {used} is "
                             f"not within 1% of the live cells' {live} bytes")
    if launches != model.depth * waves.get("cold", 0):
        raise AssertionError(f"prefix_paged {label}: {launches} flash "
                             f"launches, not {model.depth} a cold wave")
    return out


def _pp_margin(model, prompt, want, got, dev) -> str:
    """Where two greedy token lists part: the step and the top-2 logit
    margin of `want`'s run there."""
    i = int(np.argmax(np.asarray(want) != np.asarray(got)))
    ids = torch.as_tensor(np.concatenate([prompt, want[:i]])[None],
                          device=dev)
    with torch.no_grad():
        top = model(ids)[0, -1].topk(2).values
    return (f"step {i}: {int(want[i])} vs {int(got[i])}, top-2 margin "
            f"{float(top[0] - top[1]):.3e}")


def _pp_fp32(fa, dev, family_fields, prompts):
    """Runs (a)-(d) in fp32 with the held checks; returns the runs."""
    from tfde_tpu_torch.inference.decode import generate
    from tfde_tpu_torch.models.gpt import GPT

    from tfde_tpu_torch.inference.server import ContinuousBatcher

    model = GPT(**family_fields, dtype=torch.float32, device=dev, seed=0)
    # untimed: the card's first programs (cuBLAS's fp32 kernels at these
    # shapes, the flash kernel's first launch) before run (a)
    srv = ContinuousBatcher(model, batch_size=PP_BATCH, max_len=PP_MAX_LEN,
                            scan_depth=PP_DEPTH, device=dev)
    for p in prompts[:PP_BATCH]:
        srv.submit(p, 2)
    srv.run()
    snap = {}

    def live_rows(srv) -> dict:
        """{request id: (row, committed cells)} of the occupied rows."""
        return {rid: (r, int(srv._committed[r]))
                for r, rid in enumerate(srv._req) if rid is not None}

    def dense_at_warm(srv, step):
        cache = srv._cache
        snap.update(step=step, rows=live_rows(srv),
                    keys=[k.clone() for k in cache.keys],
                    values=[v.clone() for v in cache.values])

    def paged_at_warm(srv, step):
        # the two layouts group a wave's rows differently: rows match by
        # request
        cache, rows = srv._cache, live_rows(srv)
        if step != snap.get("step") or {
                rid: c for rid, (_, c) in rows.items()} != {
                rid: c for rid, (_, c) in snap["rows"].items()}:
            raise AssertionError(
                f"prefix_paged: the first warm admission came at step "
                f"{step} with {rows} paged, at {snap.get('step')} with "
                f"{snap.get('rows')} dense")
        b = cache.table.shape[0]
        by_layer = []
        for layer in range(model.depth):
            rel = 0.0
            for pool, slab in ((cache.keys[layer], snap["keys"][layer]),
                               (cache.values[layer], snap["values"][layer])):
                got = pool[cache.table].reshape(b, -1, *pool.shape[2:])
                g = torch.cat([got[r, :c] for r, c in rows.values()])
                w = torch.cat([slab[snap["rows"][rid][0], :c]
                               for rid, (_, c) in rows.items()])
                rel = max(rel, _rel(g, w))
            by_layer.append(rel)
        layer_k = cache.keys[0]
        snap.update(gather=by_layer,
                    gather_ms=_time_ms(lambda: layer_k[cache.table], dev),
                    cells=sum(c for _, c in rows.values()))

    runs = {}
    runs["a"] = _pp_run(fa, dev, model, prompts, "fp32 (a) dense",
                        keep_layer0=True, paged=False, prefix_cache=False)
    runs["b"] = _pp_run(fa, dev, model, prompts, "fp32 (b) dense + prefix "
                        "cache", at_warm=dense_at_warm, paged=False,
                        prefix_cache=True)
    runs["c"] = _pp_run(fa, dev, model, prompts, "fp32 (c) paged + trie",
                        at_warm=paged_at_warm, paged=True, prefix_cache=True)
    block_bytes = 2 * model.depth * 16 * model.kv_heads * model.head_dim * 4
    os.environ["TFDE_KV_DEFRAG_THRESHOLD"] = PP_DEFRAG
    try:
        runs["d"] = _pp_run(fa, dev, model, prompts,
                            f"fp32 (d) paged + trie of {PP_TRIE_BLOCKS} "
                            f"blocks, pool {PP_SMALL_POOL} blocks, defrag "
                            f"threshold {PP_DEFRAG}", paged=True,
                            prefix_cache=PP_TRIE_BLOCKS * block_bytes,
                            pool_blocks=PP_SMALL_POOL)
    finally:
        del os.environ["TFDE_KV_DEFRAG_THRESHOLD"]
    by_layer = snap["gather"]
    tick_ms = runs["c"]["stats"]["decode_s"] * 1e3 / runs["c"]["stats"][
        "rounds"]
    print(f"prefix_paged fp32 gather: after the first warm wave (step "
          f"{snap['step']}), every row's table gathered into position order "
          f"vs run (b)'s dense cache over {snap['cells']} committed cells a "
          f"layer, worst rel of k and v by layer "
          f"[{', '.join(f'{r:.2e}' for r in by_layer)}] (tol "
          f"{PP_GATHER_TOL:g}); one layer's k gather "
          f"{snap['gather_ms']:.4f} ms, x {2 * model.depth} a tick = "
          f"{2 * model.depth * snap['gather_ms']:.3f} ms of run (c)'s "
          f"{tick_ms:.3f} ms a decode tick")
    want = runs["a"]["tokens"]
    for key in "bcd":
        bad = [i for i, (w, g) in enumerate(zip(want, runs[key]["tokens"]))
               if not np.array_equal(w, g)]
        for i in bad[:3]:
            print(f"prefix_paged fp32 ({key}) request {i} differs from (a) at "
                  f"{_pp_margin(model, prompts[i], want[i], runs[key]['tokens'][i], dev)}")
        print(f"prefix_paged fp32 ({key}): greedy tokens equal to (a)'s for "
              f"{len(want) - len(bad)}/{len(want)} requests (held)")
        if bad:
            raise AssertionError(f"prefix_paged: run ({key})'s greedy tokens "
                                 f"differ from run (a)'s")
    same = 0
    for i in range(4):
        ref = generate(model, prompts[i][None], PP_NEW, device=dev)[0]
        ref = ref[0, prompts[i].size:].cpu().numpy()
        if np.array_equal(ref, want[i]):
            same += 1
        else:
            print(f"prefix_paged fp32: request {i} differs from generate at "
                  f"{_pp_margin(model, prompts[i], ref, want[i], dev)}")
    print(f"prefix_paged fp32: the first four requests' greedy tokens == "
          f"generate on the card: {same}/4 (held)")
    if same != 4:
        raise AssertionError("prefix_paged: the batcher's greedy tokens "
                             "differ from generate's")
    for key in "bc":
        t = runs[key]["trie"]
        if not (t["hits"] > 0 and runs[key]["warm"] and min(
                runs[key]["reused"][r] for r in runs[key]["warm"])
                >= PP_SYSTEM):
            raise AssertionError(f"prefix_paged: run ({key}) reused fewer "
                                 f"than {PP_SYSTEM} tokens a warm request")
    if not max(by_layer) <= PP_GATHER_TOL:
        raise AssertionError("prefix_paged: the paged gather disagrees with "
                             "the dense cache")
    if not (runs["d"]["trie"]["evictions"] >= 1 and runs["d"]["defrags"] >= 1):
        raise AssertionError("prefix_paged: run (d) neither evicted nor "
                             "defragmented")
    _pp_int8_fp32(fa, dev, model, prompts, runs, block_bytes)
    del model
    return runs


def _pp_match(got, ref) -> float:
    """The share of greedy tokens equal position by position over the
    request set (JAX tests/test_kv_quant.py `_match_rate`)."""
    hit = tot = 0
    for g, r in zip(got, ref):
        tot += max(len(g), len(r))
        hit += sum(1 for a, b in zip(g, r) if a == b)
    return hit / max(tot, 1)


def _pp_flip(model, prompt, want, got, dev) -> tuple:
    """At the first step where `got` (an int8 run) parts from `want` (its
    fp twin): (step, the twin's top-2 logit margin there, the max abs
    logit error of int8 KV there, whether the int8 function's top token is
    `got`'s, that function's top-2 margin), computed on the twin's tokens:
    the fp model without a cache, and the same sequence prefilled into an
    int8 cache."""
    from tfde_tpu_torch.inference.decode import init_cache

    i = int(np.argmax(np.asarray(want) != np.asarray(got)))
    ids = torch.as_tensor(np.concatenate([prompt, want[:i]])[None],
                          device=dev)
    with torch.no_grad():
        fp = model.head(model.hidden(ids)[:, -1])[0]
        cache = init_cache(model, 1, ids.shape[1], kv_quant="int8")
        q8 = model.head(model.hidden(ids, cache=cache)[:, -1])[0]
    top, top8 = fp.topk(2), q8.topk(2)
    return (i, float(top.values[0] - top.values[1]),
            float((fp - q8).abs().max()),
            int(top8.indices[0]) == int(got[i]),
            float(top8.values[0] - top8.values[1]))


def _pp_twin(model, prompts, key, run, twin, dev, floor=None) -> float:
    """Hold an int8 run against its fp twin: the same flash launches, and
    (with `floor`) every request matching its twin token for token or
    parting where the int8 function explains it (PP_MATCH_FLOOR's note);
    returns the greedy-match rate."""
    rate = _pp_match(run["tokens"], twin["tokens"])
    bad = [i for i, (g, w) in enumerate(zip(run["tokens"], twin["tokens"]))
           if not np.array_equal(g, w)]
    flips = [(i,) + _pp_flip(model, prompts[i], twin["tokens"][i],
                             run["tokens"][i], dev)
             for i in (bad if floor is not None else bad[:3])]
    for i, step, margin, err, follows, margin8 in flips[:6]:
        print(f"prefix_paged {key} request {i} parts from its fp twin at "
              f"step {step}: the twin's top-2 margin {margin:.3e}, the int8 "
              f"logit error there {err:.3e}; the int8 function's top token "
              f"{'is' if follows else 'is NOT'} the run's (its top-2 margin "
              f"{margin8:.3e})")
    worst = max((f[3] for f in flips), default=0.0)
    ties = sum(not f[4] and f[5] < 10 * PP_FLIP_SLACK for f in flips)
    print(f"prefix_paged {key}: greedy match {rate:.4f} against its fp twin "
          f"({len(bad)}/{len(prompts)} requests differ; JAX accepts >= "
          f"{PP_MATCH_FLOOR} where the margins exceed the int8 error: not "
          f"held here); the largest int8 logit error where they part "
          f"{worst:.3e}, int8 ties {ties}"
          f"{'' if floor is None else ' (held: every parting explained, PP_MATCH_FLOOR)'}; flash "
          f"launches {run['launches']} vs {twin['launches']}; "
          f"{run['tick_ms']:.2f} vs {twin['tick_ms']:.2f} ms a tick "
          f"({run['tick_ms'] / twin['tick_ms'] - 1:+.1%}), peak "
          f"{run['peak']:.2f} vs {twin['peak']:.2f} GiB, KV allocated "
          f"{run['kv']['allocated_bytes']:.0f} vs "
          f"{twin['kv']['allocated_bytes']:.0f} bytes")
    if run["launches"] != twin["launches"]:
        raise AssertionError(f"prefix_paged {key}: {run['launches']} flash "
                             f"launches, its fp twin {twin['launches']}")
    for i, step, margin, err, follows, margin8 in (
            flips if floor is not None else []):
        if not (margin <= 2 * err + PP_FLIP_SLACK
                and (follows or margin8 < 10 * PP_FLIP_SLACK)):
            raise AssertionError(
                f"prefix_paged {key}: request {i} parts from its fp twin at "
                f"step {step} where the int8 function does not explain it "
                f"(margin {margin:.3e}, int8 error {err:.3e}, the int8 "
                f"function's top token the run's: {follows})")
    return rate


def _pp_int8_fp32(fa, dev, model, prompts, runs, block_bytes):
    """Runs (e)-(g) in fp32 with int8 KV, held against (a), (c), (d); the
    headroom of idle batchers under PP_BUDGET."""
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.ops.quant import kv_quantize

    runs["e"] = _pp_run(fa, dev, model, prompts, "fp32 (e) dense, int8 KV",
                        keep_layer0=True, paged=False, prefix_cache=False,
                        kv_quant="int8")
    runs["f"] = _pp_run(fa, dev, model, prompts, "fp32 (f) paged + trie, "
                        "int8 KV", paged=True, prefix_cache=True,
                        kv_quant="int8")
    cell_q8 = 2 * model.depth * model.kv_heads * (model.head_dim + 4)
    pool_q8 = PP_SMALL_POOL * block_bytes // (16 * cell_q8)
    os.environ["TFDE_KV_DEFRAG_THRESHOLD"] = PP_DEFRAG
    try:
        runs["g"] = _pp_run(fa, dev, model, prompts,
                            f"fp32 (g) paged + trie of {PP_TRIE_BLOCKS} fp32 "
                            f"blocks' bytes, pool {pool_q8} int8 blocks (the "
                            f"bytes of {PP_SMALL_POOL} fp32 blocks), int8 KV",
                            paged=True,
                            prefix_cache=PP_TRIE_BLOCKS * block_bytes,
                            pool_blocks=pool_q8, kv_quant="int8")
    finally:
        del os.environ["TFDE_KV_DEFRAG_THRESHOLD"]
    # (e)'s layer-0 cache against the quantizer of (a)'s: layer 0's K/V
    # depend on no earlier layer and both runs schedule the same waves
    a, e = runs["a"], runs["e"]
    if a["rows_last"] != e["rows_last"]:
        raise AssertionError("prefix_paged: (a) and (e) ended with other "
                             "requests in their rows")
    cells = 0
    for r, i in e["rows_last"].items():
        n = prompts[i].size
        for name in "kv":
            q, scale = kv_quantize(a["layer0"][name][r, :n])
            if not (torch.equal(e["layer0"][name][r, :n], q) and torch.equal(
                    e["layer0"][f"{name}_scale"][r, :n], scale)):
                raise AssertionError(
                    f"prefix_paged: (e)'s layer-0 {name} of row {r} is not "
                    f"kv_quantize of (a)'s")
        cells += n
    print(f"prefix_paged fp32 (e): layer 0's int8 k and v payloads and "
          f"scales equal kv_quantize of (a)'s fp32 layer 0 bit for bit over "
          f"the {cells} prompt cells of the {len(e['rows_last'])} rows "
          f"resident at the end (held)")
    del a["layer0"], e["layer0"]
    for key, twin in (("e", "a"), ("f", "c"), ("g", "d")):
        _pp_twin(model, prompts, f"fp32 ({key})", runs[key], runs[twin], dev,
                 floor=PP_MATCH_FLOOR)
    d, g = runs["d"], runs["g"]
    bytes_d = PP_SMALL_POOL * block_bytes
    bytes_g = pool_q8 * 16 * cell_q8
    print(f"prefix_paged (g) vs (d): {g['blocks']} int8 blocks in {bytes_g} "
          f"bytes against {d['blocks']} fp32 blocks in {bytes_d} bytes "
          f"({g['blocks'] / d['blocks']:.3f}x the blocks); capacity stalls "
          f"{g['stalls']} vs {d['stalls']}, trie evictions "
          f"{g['trie']['evictions']} vs {d['trie']['evictions']}, defrags "
          f"{g['defrags']} vs {d['defrags']}; {g['tok_s']:.1f} vs "
          f"{d['tok_s']:.1f} tok/s (held: >= 0.99 x 4D / (D + 4) = "
          f"{0.99 * 4 * model.head_dim / (model.head_dim + 4):.3f}x the "
          f"blocks in no more bytes, fewer stalls)")
    if not (bytes_g <= bytes_d and g["stalls"] < d["stalls"]
            and g["blocks"] >= 0.99 * 4 * model.head_dim
            / (model.head_dim + 4) * d["blocks"]):
        raise AssertionError("prefix_paged: (g) does not hold more blocks in "
                             "(d)'s bytes, or stalls as often")
    ratio = e["kv"]["allocated_bytes"] / a["kv"]["allocated_bytes"]
    want = (model.head_dim + 4) / (4 * model.head_dim)
    print(f"prefix_paged: dense KV slab {a['kv']['allocated_bytes']:.0f} "
          f"bytes fp32, {e['kv']['allocated_bytes']:.0f} int8 (ratio "
          f"{ratio:.6f}, (D + 4) / 4D = {want:.6f}; held)")
    if ratio != want:
        raise AssertionError("prefix_paged: the int8 slab's bytes are not "
                             "(D + 4) / 4D of the fp32 slab's")
    os.environ["TFDE_CAPACITY_BUDGET_BYTES"] = str(PP_BUDGET)
    try:
        head = {}
        for q in ("fp", "int8"):
            srv = ContinuousBatcher(model, batch_size=PP_BATCH,
                                    max_len=PP_MAX_LEN, device=dev,
                                    kv_quant=q)
            head[q] = srv.kv_stats()
            del srv
    finally:
        del os.environ["TFDE_CAPACITY_BUDGET_BYTES"]
    cell_fp = 2 * model.depth * model.kv_heads * model.head_dim * 4
    # CapacityModel caps both at the idle batcher's free rows
    want = {q: (min(PP_BATCH, PP_BUDGET // (cell * PP_MAX_LEN)),
                min(PP_BATCH * PP_MAX_LEN, PP_BUDGET // cell))
            for q, cell in (("fp", cell_fp), ("int8", cell_q8))}
    got = {q: (h["headroom_rows"], h["headroom_tokens"])
           for q, h in head.items()}
    print(f"prefix_paged: idle dense batchers under "
          f"TFDE_CAPACITY_BUDGET_BYTES={PP_BUDGET}: headroom (rows, tokens) "
          f"fp32 {got['fp']}, int8 {got['int8']} "
          f"({got['int8'][1] / got['fp'][1]:.4f}x the tokens; held at "
          f"{want})")
    if got != want:
        raise AssertionError("prefix_paged: the headroom under the budget "
                             "is not the cells' arithmetic")
    torch.cuda.empty_cache()


def phase_prefix_paged(fa, dev):
    """The prefix-KV cache and paged KV in the batcher (docstring, phase
    16)."""
    import gc

    from tfde_tpu_torch.models.gpt import GPT
    from tfde_tpu_torch.testing import FULL_WIDTH

    print(f"prefix_paged on {_card()}")
    fields = FULL_WIDTH["Llama-3.2-1B"][1]
    prompts = _pp_prompts(fields["vocab_size"])
    print(f"prefix_paged: Llama-3.2-1B (published widths, random weights "
          f"from seed 0), batch {PP_BATCH}, max_len {PP_MAX_LEN}, scan depth "
          f"{PP_DEPTH}; {PP_REQUESTS} requests x {PP_NEW} of a {PP_SYSTEM}"
          f"-token system prompt + {PP_SUFFIX[0]}-{PP_SUFFIX[1]} tokens, "
          f"prompt lengths {[int(p.size) for p in prompts]}, requests "
          f"{sorted(PP_REPEATS)} repeating {list(PP_REPEATS.values())}")
    fp32 = _pp_fp32(fa, dev, fields, prompts)
    gc.collect()
    torch.cuda.empty_cache()
    model = GPT(**fields, device=dev, seed=0).cast_compute_weights_()
    bf16 = {}
    for key, label, kw in (
            ("a", "bf16 (a) dense", dict(paged=False, prefix_cache=False)),
            ("b", "bf16 (b) dense + prefix cache",
             dict(paged=False, prefix_cache=True)),
            ("c", "bf16 (c) paged + trie", dict(paged=True,
                                                prefix_cache=True)),
            ("e", "bf16 (e) dense, int8 KV",
             dict(paged=False, prefix_cache=False, kv_quant="int8"))):
        bf16[key] = _pp_run(fa, dev, model, prompts, label, **kw)
    _pp_twin(model, prompts, "bf16 (e)", bf16["e"], bf16["a"], dev)
    ratio = (bf16["e"]["kv"]["allocated_bytes"]
             / bf16["a"]["kv"]["allocated_bytes"])
    want = (model.head_dim + 4) / (2 * model.head_dim)
    print(f"prefix_paged: dense KV slab {bf16['a']['kv']['allocated_bytes']:.0f}"
          f" bytes bf16, {bf16['e']['kv']['allocated_bytes']:.0f} int8 (ratio "
          f"{ratio:.6f}, (D + 4) / 2D = {want:.6f}; held)")
    if ratio != want:
        raise AssertionError("prefix_paged: the int8 slab's bytes are not "
                             "(D + 4) / 2D of the bf16 slab's")
    for key in "bc":
        diff = sum(not np.array_equal(w, g) for w, g in zip(
            bf16["a"]["tokens"], bf16[key]["tokens"]))
        print(f"prefix_paged bf16 ({key}): {diff}/{PP_REQUESTS} requests' "
              f"greedy tokens differ from bf16 (a)'s (counted: bf16 is not "
              f"batch-invariant, and warm and paged rows take the einsum)")
    for key in "bc":
        if not bf16[key]["trie"]["hits"]:
            raise AssertionError(f"prefix_paged: bf16 run ({key}) had no "
                                 f"prefix hits")
    print(f"prefix_paged summary (fp32 / bf16): ms per output token dense "
          f"{fp32['a']['ms_token']:.2f} / {bf16['a']['ms_token']:.2f}, "
          f"dense int8 KV {fp32['e']['ms_token']:.2f} / "
          f"{bf16['e']['ms_token']:.2f}, paged int8 KV "
          f"{fp32['f']['ms_token']:.2f}, cut pool fp / int8 "
          f"{fp32['d']['ms_token']:.2f} / {fp32['g']['ms_token']:.2f}, "
          f"prefix cache {fp32['b']['ms_token']:.2f} / "
          f"{bf16['b']['ms_token']:.2f}, paged {fp32['c']['ms_token']:.2f} / "
          f"{bf16['c']['ms_token']:.2f}; run (b)'s TTFT warm vs cold "
          f"{fp32['b']['ttft_warm']:.1f} vs {fp32['b']['ttft_cold']:.1f} ms / "
          f"{bf16['b']['ttft_warm']:.1f} vs {bf16['b']['ttft_cold']:.1f} ms, "
          f"in the admission wave {fp32['b']['wave_warm']:.1f} vs "
          f"{fp32['b']['wave_cold']:.1f} ms / {bf16['b']['wave_warm']:.1f} vs "
          f"{bf16['b']['wave_cold']:.1f} ms")
    del model
    gc.collect()
    torch.cuda.empty_cache()


#: admission: Llama-3.2-1B at its published widths behind the role split.
#: A prefill replica (batch 1) primes AD_PRIMED requests, a decode replica
#: (batch AD_BATCH, max_len 1024, scan depth 4) admits them beside
#: AD_PLAIN plain submits, AD_NEW new tokens each (16 until PR 17: cut to
#: keep the whole script inside its time limit); prompts of
#: AD_PROMPT[0]-AD_PROMPT[1] tokens from seed 0
AD_BATCH, AD_MAX_LEN, AD_DEPTH, AD_NEW = 8, 1024, 4, 8
AD_PRIMED, AD_PLAIN, AD_PROMPT = 16, 8, (100, 900)
#: the four layouts of the hand-off: (paged, kv_quant)
AD_LAYOUTS = {"dense": (False, "fp"), "paged": (True, "fp"),
              "dense int8": (False, "int8"), "paged int8": (True, "int8")}
#: predicted payload bytes a prompt token (16 layers x 8 KV heads x D 64,
#: k and v): fp32 65,536, bf16 32,768, int8 16,384 + its fp32 scales 1,024
AD_TOKEN_BYTES = {"fp32": 65_536, "bf16": 32_768, "int8": 17_408}
#: the headroom gate: a budget of AD_GATE_ROWS bf16 max-length rows, the
#: floor one row, requests of AD_GATE_PROMPT tokens x AD_GATE_NEW (active
#: while the batch fills: one decode round of <= 4 ticks a submit)
AD_GATE_ROWS, AD_GATE_PROMPT, AD_GATE_NEW = 3, 600, 64


def _ad_prompts(vocab: int) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(rng.integers(AD_PROMPT[0],
                                                    AD_PROMPT[1] + 1)))
            for _ in range(AD_PRIMED + AD_PLAIN)]


def _ad_watch_waves(srv, fa, dev):
    """Record every admission group of `srv`: (kind, requests, ms, flash
    launches). A synchronize closes each group for its time (the primed
    wave itself never syncs)."""
    waves = []
    run_group = srv._run_group

    def timed(kind, key, group, rows):
        torch.cuda.synchronize(dev)
        n0, t0 = fa.flash_forward.launches, time.perf_counter()
        out = run_group(kind, key, group, rows)
        torch.cuda.synchronize(dev)
        waves.append((kind, len(group), (time.perf_counter() - t0) * 1e3,
                      fa.flash_forward.launches - n0))
        return out

    srv._run_group = timed
    return waves


def _ad_prime(fa, dev, model, prompts, kv_quant, label):
    """Prime `prompts` on a prefill replica; each prime must launch the
    forward once a layer. Returns the payloads and the ms of each."""
    from tfde_tpu_torch.inference.server import ContinuousBatcher

    pre = ContinuousBatcher(model, batch_size=1, max_len=AD_MAX_LEN,
                            role="prefill", kv_quant=kv_quant, device=dev)
    pre.prime(prompts[0], 2)  # untimed: the programs' first launch
    primed, ms = [], []
    for p in prompts:
        _zero_counts(fa)
        t0 = time.perf_counter()
        primed.append(pre.prime(p, AD_NEW))  # ends in its one fetch
        ms.append((time.perf_counter() - t0) * 1e3)
        if fa.flash_forward.launches != model.depth:
            raise AssertionError(
                f"admission {label}: prime() launched the forward "
                f"{fa.flash_forward.launches} times, not {model.depth}")
    tok = sum(int(p.size) for p in prompts)
    nbytes = [sum(t.numel() * t.element_size() for t in pr.kv.values())
              for pr in primed]
    print(f"admission {label}: prime() of {len(prompts)} requests "
          f"({tok} prompt tokens): ms a request median "
          f"{float(np.median(ms)):.3f}, range {min(ms):.3f}-{max(ms):.3f}; "
          f"flash_fwd {model.depth} launches a prime; payload "
          f"{sum(nbytes) / len(nbytes):.0f} bytes a request, "
          f"{sum(nbytes) / tok:.1f} a prompt token")
    return primed, ms, sum(nbytes) / tok


def _ad_wire(primed, label):
    """Every payload across the JSON wire and back; the planes must come
    back bit for bit. Returns the decoded payloads."""
    from tfde_tpu_torch.inference.router import (primed_from_json,
                                                 primed_to_json)

    enc, dec, size, back = 0.0, 0.0, 0, []
    for pr in primed:
        t0 = time.perf_counter()
        text = json.dumps(primed_to_json(pr))
        t1 = time.perf_counter()
        got = primed_from_json(json.loads(text))
        t2 = time.perf_counter()
        enc, dec, size = enc + t1 - t0, dec + t2 - t1, size + len(text)
        if got.first_token != pr.first_token or set(got.kv) != set(pr.kv) \
                or not all(torch.equal(got.kv[n], t)
                           for n, t in pr.kv.items()):
            raise AssertionError(f"admission {label}: a payload changed on "
                                 f"the wire")
        back.append(got)
    n = len(primed)
    print(f"admission {label}: JSON wire {size / n:.0f} bytes a request, "
          f"encode {enc * 1e3 / n:.2f} ms, decode {dec * 1e3 / n:.2f} ms a "
          f"request")
    return back


def _ad_decode(fa, dev, model, primed, plain, paged, kv_quant, label):
    """The decode replica: the primed payloads and the plain prompts,
    interleaved two primed to one plain, AD_NEW tokens each. Returns the
    tokens (primed first, then plain), the waves and the TTFTs."""
    from tfde_tpu_torch.inference.server import ContinuousBatcher

    srv = ContinuousBatcher(model, batch_size=AD_BATCH, max_len=AD_MAX_LEN,
                            scan_depth=AD_DEPTH, role="decode",
                            paged=paged, kv_quant=kv_quant, device=dev)
    waves = _ad_watch_waves(srv, fa, dev)
    torch.cuda.synchronize(dev)
    _zero_counts(fa)
    t0 = time.perf_counter()
    p_ids, c_ids = [], []
    for i, pr in enumerate(primed):
        p_ids.append(srv.submit_primed(pr))
        if i % 2 and len(c_ids) < len(plain):
            c_ids.append(srv.submit(plain[len(c_ids)], AD_NEW))
    c_ids += [srv.submit(p, AD_NEW) for p in plain[len(c_ids):]]
    done = dict(srv.run())
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    for kind, n, _ms, launches in waves:
        want = model.depth if kind == "cold" else 0
        if launches != want:
            raise AssertionError(f"admission {label}: a {kind} wave of {n} "
                                 f"launched the forward {launches} times")
    ttft = srv.ttft_ms()
    stats = srv.stats()
    emitted = stats["generated"] - len(done)  # less each first token
    tok_s = emitted / stats["decode_s"]
    out = dict(tokens=[done[r] for r in p_ids + c_ids], waves=waves,
               ttft_primed=float(np.mean([ttft[r] for r in p_ids])),
               ttft_plain=float(np.mean([ttft[r] for r in c_ids])),
               drain=srv.admission.drain_rate_tps, tok_s=tok_s)
    by = {}
    for kind, n, ms, _l in waves:
        k = by.setdefault(kind, [0, 0, 0.0])
        k[0], k[1], k[2] = k[0] + 1, k[1] + n, k[2] + ms
    print(f"admission {label}: decode replica, {len(done)} requests in "
          f"{dt:.3f} s, waves " + ", ".join(
              f"{k} {v[0]} ({v[1]} requests, {v[2]:.2f} ms, "
              f"{v[2] / v[1]:.3f} ms a request)" for k, v in by.items())
          + f"; mean TTFT primed {out['ttft_primed']:.1f} ms, plain "
          f"{out['ttft_plain']:.1f} ms; drain_rate_tps {out['drain']:.1f} "
          f"against {tok_s:.1f} tok/s over the same rounds "
          f"({emitted} tokens in {stats['decode_s']:.3f} s of decode "
          f"rounds)")
    return out


def _ad_solo(dev, model, prompts, primed, kv_quant, label):
    """Each prompt alone on a 'both' batcher (batch 1): its greedy tokens,
    and the slab row its cold admission writes against the payload that
    prime() shipped (bit for bit, over the prompt's cells)."""
    from tfde_tpu_torch.inference.server import ContinuousBatcher

    srv = ContinuousBatcher(model, batch_size=1, max_len=AD_MAX_LEN,
                            scan_depth=AD_DEPTH, kv_quant=kv_quant,
                            device=dev)
    tokens, cells = [], 0
    for i, p in enumerate(prompts):
        rid = srv.submit(p, AD_NEW)
        done = dict(srv.step())
        if i < len(primed):
            for name, t in primed[i].kv.items():
                row = srv._cache.planes()[name][0, :p.size].cpu()
                if not torch.equal(row, t):
                    raise AssertionError(
                        f"admission {label}: request {i}'s shipped plane "
                        f"{name} differs from its solo admission's row")
            cells += int(p.size)
        done.update(srv.run())
        tokens.append(done[rid])
    print(f"admission {label}: shipped planes bit-equal to the solo cold "
          f"admissions' slab rows over {cells} prompt cells x "
          f"{len(primed[0].kv)} planes")
    return tokens


def _ad_split(fa, dev, fields, prompts):
    """The role split in fp32 (held exactly) and bf16 (timed)."""
    import gc

    from tfde_tpu_torch.models.gpt import GPT

    model = GPT(**fields, dtype=torch.float32, device=dev, seed=0)
    primed_p, plain = prompts[:AD_PRIMED], prompts[AD_PRIMED:]
    for kvq in ("fp", "int8"):
        fmt = "fp32" if kvq == "fp" else "int8"
        primed, _ms, per_tok = _ad_prime(fa, dev, model, primed_p, kvq,
                                         f"fp32 {fmt} KV")
        if per_tok != AD_TOKEN_BYTES[fmt]:
            raise AssertionError(f"admission: {per_tok} payload bytes a "
                                 f"token, not {AD_TOKEN_BYTES[fmt]}")
        wire = _ad_wire(primed, f"fp32 {fmt} KV")
        solo = _ad_solo(dev, model, prompts, primed, kvq, f"fp32 {fmt} KV")
        for name, (paged, q) in AD_LAYOUTS.items():
            if q != kvq:
                continue
            run = _ad_decode(fa, dev, model, wire, plain, paged, q,
                             f"fp32 {name}")
            diff = [i for i, (a, b) in enumerate(zip(run["tokens"], solo))
                    if not np.array_equal(a, b)]
            if diff:
                raise AssertionError(f"admission fp32 {name}: requests "
                                     f"{diff} differ from their solo runs")
            print(f"admission fp32 {name}: all {len(solo)} requests' greedy "
                  f"tokens equal their solo runs ({AD_PRIMED} primed)")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = GPT(**fields, device=dev, seed=0).cast_compute_weights_()
    primed, _ms, per_tok = _ad_prime(fa, dev, model, primed_p, "fp",
                                     "bf16")
    if per_tok != AD_TOKEN_BYTES["bf16"]:
        raise AssertionError(f"admission: {per_tok} bf16 payload bytes a "
                             f"token, not {AD_TOKEN_BYTES['bf16']}")
    wire = _ad_wire(primed, "bf16")
    split = _ad_decode(fa, dev, model, wire, plain, False, "fp", "bf16 dense")
    # the same requests all submitted plainly: the primed groups' prompts
    # prefill in cold waves of the same buckets
    from tfde_tpu_torch.inference.server import ContinuousBatcher

    srv = ContinuousBatcher(model, batch_size=AD_BATCH, max_len=AD_MAX_LEN,
                            scan_depth=AD_DEPTH, device=dev)
    waves = _ad_watch_waves(srv, fa, dev)
    for p in primed_p:
        srv.submit(p, AD_NEW)
    srv.run()
    primed_ms = sum(ms for k, _n, ms, _l in split["waves"] if k == "primed")
    cold_ms = sum(ms for _k, _n, ms, _l in waves)
    print(f"admission bf16: the {AD_PRIMED} primed requests' waves "
          f"{primed_ms:.2f} ms against {cold_ms:.2f} ms for the same "
          f"requests in cold waves ({len(waves)} waves)")
    return model


def _ad_backlog(dev, model, vocab):
    """A QueueFull's Retry-After against the seconds its backlog took to
    drain: a full batch with a queue behind it under a queued-token cap."""
    from tfde_tpu_torch.inference import admission
    from tfde_tpu_torch.inference.server import ContinuousBatcher

    rng = np.random.default_rng(1)
    cap = 2 * AD_BATCH * 32
    srv = ContinuousBatcher(
        model, batch_size=AD_BATCH, max_len=AD_MAX_LEN, scan_depth=AD_DEPTH,
        device=dev,
        admission_ctl=admission.AdmissionController(max_queued_tokens=cap))
    for _ in range(2 * AD_BATCH):
        srv.submit(rng.integers(0, vocab, 64), 32)
    for _ in range(3):
        srv.step()  # the drain rate settles
    while srv.queued_tokens + 32 <= cap:
        srv.submit(rng.integers(0, vocab, 64), 32)
    try:
        srv.submit(rng.integers(0, vocab, 64), 32)
        raise AssertionError("admission: the token cap admitted past it")
    except admission.QueueFull as e:
        if e.reason != "queued_tokens":
            raise AssertionError(f"admission: rejected as {e.reason}")
        retry, backlog = e.retry_after_s, e.queued_tokens + 32
    t0, gen0 = time.perf_counter(), srv.stats()["generated"]
    while srv.stats()["generated"] - gen0 < backlog and not srv.idle:
        srv.step()
    took = time.perf_counter() - t0
    srv.run()
    print(f"admission: a QueueFull under max_queued_tokens {cap} at "
          f"drain_rate_tps {srv.admission.drain_rate_tps:.1f} said "
          f"Retry-After {retry:.3f} s; its backlog of {backlog} tokens "
          f"took {took:.3f} s to drain")


def _ad_headroom(dev, model, vocab):
    """The KV-headroom gate under a budget of AD_GATE_ROWS bf16 rows: each
    submit is rejected exactly when kv_stats()'s headroom_rows just before
    it is below the floor; int8 KV admits more rows in the same bytes."""
    from tfde_tpu_torch.inference import admission
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.testing import env_set

    row = AD_MAX_LEN * AD_TOKEN_BYTES["bf16"]
    budget = AD_GATE_ROWS * row
    rng = np.random.default_rng(2)
    admitted = {}
    for kvq in ("fp", "int8"):
        with env_set(TFDE_CAPACITY_BUDGET_BYTES=str(budget)):
            srv = ContinuousBatcher(
                model, batch_size=AD_BATCH, max_len=AD_MAX_LEN,
                scan_depth=AD_DEPTH, kv_quant=kvq, device=dev,
                admission_ctl=admission.AdmissionController(
                    min_headroom_rows=1))
        n, trail = 0, []
        while True:
            head = srv.kv_stats()["headroom_rows"]
            try:
                srv.submit(rng.integers(0, vocab, AD_GATE_PROMPT),
                           AD_GATE_NEW)
                rejected = None
            except admission.QueueFull as e:
                rejected = e
            trail.append(head)
            if (rejected is not None) != (head < 1):
                raise AssertionError(
                    f"admission headroom {kvq}: headroom {head} rows, "
                    f"{'rejected' if rejected else 'admitted'}")
            if rejected is not None:
                if (rejected.reason != "kv_headroom"
                        or rejected.kv["headroom_rows"] != head):
                    raise AssertionError(f"admission headroom {kvq}: "
                                         f"{rejected.as_json()}")
                break
            n += 1
            srv.step()
            if srv.free_rows + n != AD_BATCH:
                raise AssertionError(f"admission headroom {kvq}: a request "
                                     f"finished while the batch filled")
        srv.run()
        admitted[kvq] = n
        print(f"admission headroom ({'int8' if kvq == 'int8' else 'bf16'} "
              f"KV, budget {budget} bytes = {AD_GATE_ROWS} bf16 rows, floor "
              f"1 row): headroom_rows before each submit {trail}; admitted "
              f"{n}, the next rejected as kv_headroom")
    if not admitted["int8"] > admitted["fp"]:
        raise AssertionError(f"admission headroom: int8 admitted "
                             f"{admitted['int8']}, bf16 {admitted['fp']}")


def phase_admission(fa, dev):
    """Admission control and the prefill/decode role split (docstring,
    phase 17)."""
    import gc

    from tfde_tpu_torch import testing
    from tfde_tpu_torch.inference import admission
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.observability import metrics

    print(f"admission on {_card()}")
    fields = testing.FULL_WIDTH["Llama-3.2-1B"][1]
    vocab = fields["vocab_size"]
    prompts = _ad_prompts(vocab)
    print(f"admission: Llama-3.2-1B (published widths, random weights from "
          f"seed 0); prefill replica batch 1, decode replica batch "
          f"{AD_BATCH}, max_len {AD_MAX_LEN}, scan depth {AD_DEPTH}; "
          f"{AD_PRIMED} primed + {AD_PLAIN} plain requests x {AD_NEW} new "
          f"tokens, prompt lengths {[int(p.size) for p in prompts]}")
    model = _ad_split(fa, dev, fields, prompts)
    reg = metrics.default_registry()
    for name in testing.ADMISSION_SCENARIOS:
        out = testing.admission_scenario(
            name, lambda **kw: ContinuousBatcher(model, scan_depth=AD_DEPTH,
                                                 device=dev, **kw),
            admission, reg, prompts[0][:4])
        print(f"admission scenario {name}: held; "
              f"{json.dumps({k: v for k, v in out.items() if k != 'tokens'})}")
    _ad_backlog(dev, model, vocab)
    _ad_headroom(dev, model, vocab)
    del model
    gc.collect()
    torch.cuda.empty_cache()


#: decoding: speculative decoding on Llama-3.2-1B with serve_gpt's
#: quarter-width draft (hidden 512, depth 4, 8 heads of D 64, MLP 2048):
#: generate_speculative at num_draft DC_DRAFT over (batch, prompt) runs x
#: DC_NEW new tokens; the batcher at batch DC_BATCH, max_len DC_MAX_LEN,
#: DC_REQUESTS requests of DC_PROMPT tokens x DC_SRV_NEW
DC_DRAFT, DC_NEW, DC_RUNS = 4, 32, ((1, 128), (1, 900), (4, 512))
DC_BATCH, DC_MAX_LEN, DC_REQUESTS = 8, 1024, 12
DC_PROMPT, DC_SRV_NEW, DC_SCAN = (100, 900), 16, 4
#: beam search: batch x beams, prompt, new tokens, length penalty; the
#: score of a beam against one cache-free forward of its sequence
BM_BATCH, BM_BEAMS, BM_PROMPT, BM_NEW, BM_PENALTY = 2, 4, 256, 32, 0.6
BM_SCORE_TOL = 1e-3
#: the rolling cache: Gemma-2-2B (window 4096, 'alternate'), batch 1
RC_PROMPT, RC_NEW = 4352, 32


def _dc_prompts(vocab, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            for _ in range(n)]


def _dc_solo(model, prompt, n, dev):
    """The greedy solo run of one [P] prompt: its N new tokens."""
    from tfde_tpu_torch.inference.decode import generate

    toks, _ = generate(model, prompt[None, :], n, device=dev)
    return toks[0, prompt.size:].cpu().numpy()


def _dc_generate_speculative(fa, dev, model, draft):
    """generate_speculative in fp32 at DC_RUNS against greedy generate;
    the target as its own draft (every round commits num_draft + 1); the
    sampled rounds with the perfect draft."""
    from tfde_tpu_torch.inference.decode import generate
    from tfde_tpu_torch.inference.speculative import generate_speculative

    rng = np.random.default_rng(0)
    rounds_each = -(-(DC_NEW - 1) // (DC_DRAFT + 1))
    for b, p in DC_RUNS:
        prompt = rng.integers(0, model.vocab_size, (b, p))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ref, _ = generate(model, prompt, DC_NEW, device=dev)
        torch.cuda.synchronize(dev)
        print(f"decoding generate fp32 batch {b} x prompt {p} x {DC_NEW} "
              f"new: {time.perf_counter() - t0:.3f} s")
        for name, d in (("small draft", draft), ("perfect draft", model)):
            _zero_counts(fa)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out, _, st = generate_speculative(
                model, d, prompt, DC_NEW, num_draft=DC_DRAFT,
                return_stats=True, device=dev)
            torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            want = model.depth + d.depth
            if fa.flash_forward.launches != want:
                raise AssertionError(
                    f"decoding: generate_speculative launched the forward "
                    f"{fa.flash_forward.launches} times, not {want}")
            if not torch.equal(out, ref):
                raise AssertionError(f"decoding: speculative ({name}) batch "
                                     f"{b} x {p} differs from generate")
            if d is model and st["rounds"] != rounds_each:
                raise AssertionError(f"decoding: the perfect draft took "
                                     f"{st['rounds']} rounds, not "
                                     f"{rounds_each}")
            print(f"decoding generate_speculative fp32 ({name}) batch {b} "
                  f"x prompt {p} x {DC_NEW} new, num_draft {DC_DRAFT}: "
                  f"tokens equal generate; {st}; flash_fwd "
                  f"{fa.flash_forward.launches} launches; {dt:.3f} s, "
                  f"{dt * 1e3 / st['rounds']:.2f} ms a round")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, p = DC_RUNS[-1]
    prompt = rng.integers(0, model.vocab_size, (b, p))
    out, lengths, st = generate_speculative(
        model, model, prompt, DC_NEW, num_draft=DC_DRAFT, temperature=0.8,
        generator=gen, return_stats=True, device=dev)
    if (st["acceptance_rate"] < 0.99
            or lengths.tolist() != [p + DC_NEW] * b):
        raise AssertionError(f"decoding: sampled perfect draft {st}")
    print(f"decoding generate_speculative sampled (temperature 0.8, the "
          f"perfect draft) batch {b} x {p}: {st}")


def _dc_serve(fa, dev, model, draft, prompts, label, plain=False):
    """The requests through SpeculativeContinuousBatcher (or, `plain`,
    ContinuousBatcher at scan depth DC_SCAN), the counters zeroed just
    before: (tokens by request, stats, wall s, decode s, flash launches,
    admission waves)."""
    from tfde_tpu_torch.inference.server import (
        ContinuousBatcher, SpeculativeContinuousBatcher)

    if plain:
        srv = ContinuousBatcher(model, batch_size=DC_BATCH,
                                max_len=DC_MAX_LEN, scan_depth=DC_SCAN,
                                device=dev)
    else:
        srv = SpeculativeContinuousBatcher(
            model, draft, batch_size=DC_BATCH, max_len=DC_MAX_LEN,
            num_draft=DC_DRAFT, device=dev)
    torch.cuda.synchronize(dev)
    _zero_counts(fa)
    t0 = time.perf_counter()
    rids = [srv.submit(p, DC_SRV_NEW) for p in prompts]
    done = dict(srv.run())
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = fa.flash_forward.launches
    st = srv.stats()
    waves = srv.wave_counts().get("cold", 0)
    emitted = st["generated"] - len(prompts)  # less each first token
    decode_s = srv._decode_s
    per_round = decode_s * 1e3 / max(st["rounds"], 1)
    print(f"decoding {label}: {len(prompts)} requests in {wall:.3f} s "
          f"({st['generated'] / wall:.1f} tok/s whole; {emitted} decode "
          f"tokens in {decode_s:.3f} s of rounds, "
          f"{emitted / decode_s:.1f} tok/s, {per_round:.2f} ms a "
          f"{'tick' if plain else 'round'}); {waves} cold waves, flash_fwd "
          f"{launches} launches; stats "
          f"{ {k: v for k, v in st.items() if not k.endswith('_s')} }")
    return [done[r] for r in rids], st, wall, launches, waves


def _dc_batcher(fa, dev, fields):
    """SpeculativeContinuousBatcher: fp32 against solo generate and its
    launches; bf16 timed with the small and the perfect draft beside the
    plain batcher."""
    import gc

    from tfde_tpu_torch.models.gpt import GPT
    from tfde_tpu_torch.serve_gpt import quarter_draft

    model = GPT(**fields, dtype=torch.float32, device=dev, seed=0)
    draft = quarter_draft(model, dev)
    print(f"decoding: draft hidden {draft.hidden_size}, depth "
          f"{draft.depth}, {draft.num_heads} heads of D {draft.head_dim}, "
          f"MLP {draft.mlp_dim}, random weights from seed 7")
    _dc_generate_speculative(fa, dev, model, draft)
    prompts = _dc_prompts(model.vocab_size, DC_REQUESTS, *DC_PROMPT, seed=1)
    print(f"decoding batcher: batch {DC_BATCH}, max_len {DC_MAX_LEN}, "
          f"num_draft {DC_DRAFT}, prompt lengths "
          f"{[int(p.size) for p in prompts]} x {DC_SRV_NEW} new")
    toks, _st, _w, launches, waves = _dc_serve(fa, dev, model, draft,
                                               prompts, "batcher fp32")
    want = (model.depth + draft.depth) * waves
    if launches != want:
        raise AssertionError(f"decoding: the batcher launched the forward "
                             f"{launches} times over {waves} waves, not "
                             f"{want}")
    diff = [i for i, (p, t) in enumerate(zip(prompts, toks))
            if not np.array_equal(t, _dc_solo(model, p, DC_SRV_NEW, dev))]
    if diff:
        raise AssertionError(f"decoding: batcher requests {diff} differ "
                             f"from their solo generate")
    print(f"decoding batcher fp32: all {len(prompts)} requests equal their "
          f"solo generate; flash_fwd {model.depth} + {draft.depth} launches "
          f"a wave")
    del model, draft
    gc.collect()
    torch.cuda.empty_cache()
    model = GPT(**fields, device=dev, seed=0).cast_compute_weights_()
    draft = quarter_draft(model, dev)
    for label, d, plain in (("batcher bf16, small draft", draft, False),
                            ("batcher bf16, perfect draft", model, False),
                            ("plain ContinuousBatcher bf16, scan depth "
                             f"{DC_SCAN}", None, True)):
        _dc_serve(fa, dev, model, d, prompts, label, plain=plain)
    return model


def _dc_beam(fa, dev, fields, bf16_model):
    """Beam search on Llama-3.2-1B: fp32 beam 1 against greedy generate,
    every beam's score against one cache-free forward, sorted and
    distinct, the prefill's launches; bf16 ms a beam step."""
    import gc

    from tfde_tpu_torch.inference.beam import beam_search
    from tfde_tpu_torch.inference.decode import generate
    from tfde_tpu_torch.models.gpt import GPT

    model = GPT(**fields, dtype=torch.float32, device=dev, seed=0)
    prompt = np.random.default_rng(2).integers(
        0, model.vocab_size, (BM_BATCH, BM_PROMPT))
    one, _, _ = beam_search(model, prompt, BM_NEW, num_beams=1,
                            length_penalty=BM_PENALTY, device=dev)
    greedy, _ = generate(model, prompt, BM_NEW, device=dev)
    if not torch.equal(one[:, 0], greedy):
        raise AssertionError("decoding: beam 1 differs from greedy generate")
    _zero_counts(fa)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    toks, scores, lengths = beam_search(model, prompt, BM_NEW,
                                        num_beams=BM_BEAMS,
                                        length_penalty=BM_PENALTY, device=dev)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if fa.flash_forward.launches != model.depth:
        raise AssertionError(f"decoding: beam search launched the forward "
                             f"{fa.flash_forward.launches} times, not "
                             f"{model.depth}")
    seqs = toks.reshape(BM_BATCH * BM_BEAMS, -1)
    with torch.no_grad():
        logp = torch.log_softmax(model(seqs), dim=-1)
    picked = logp[:, BM_PROMPT - 1:-1].gather(
        2, seqs[:, BM_PROMPT:, None])[..., 0]
    joint = picked.sum(dim=1).view(BM_BATCH, BM_BEAMS)
    norm = (lengths - BM_PROMPT).float() ** BM_PENALTY
    err = float((scores * norm - joint).abs().max())
    if err > BM_SCORE_TOL:
        raise AssertionError(f"decoding: beam scores {err:.3e} from the "
                             f"cache-free forward")
    if not bool((scores[:, 1:] <= scores[:, :-1]).all()) or any(
            len({tuple(b) for b in row.tolist()}) != BM_BEAMS
            for row in toks):
        raise AssertionError("decoding: beams not sorted or not distinct")
    print(f"decoding beam search fp32 batch {BM_BATCH} x {BM_BEAMS} beams, "
          f"prompt {BM_PROMPT} x {BM_NEW} new, length_penalty "
          f"{BM_PENALTY}: beam 1 equals greedy generate; every beam's score "
          f"within {err:.3e} of one cache-free forward (tol "
          f"{BM_SCORE_TOL:g}); sorted and distinct; flash_fwd "
          f"{model.depth} launches (the [{BM_BATCH * BM_BEAMS}, "
          f"{BM_PROMPT}] prefill); {dt:.3f} s; best scores "
          f"{scores[:, 0].tolist()}")
    del model, logp
    gc.collect()
    torch.cuda.empty_cache()
    times = {}
    for n in (1, BM_NEW):
        beam_search(bf16_model, prompt, n, num_beams=BM_BEAMS, device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        beam_search(bf16_model, prompt, n, num_beams=BM_BEAMS, device=dev)
        torch.cuda.synchronize(dev)
        times[n] = time.perf_counter() - t0
    print(f"decoding beam search bf16: {times[BM_NEW] * 1e3:.1f} ms for "
          f"{BM_NEW} tokens, {times[1] * 1e3:.1f} ms for the prefill and "
          f"the first; "
          f"{(times[BM_NEW] - times[1]) * 1e3 / (BM_NEW - 1):.2f} ms a beam "
          f"step ({BM_BATCH * BM_BEAMS} rows)")


def _dc_rolling(fa, dev, fields):
    """Gemma-2-2B fp32 on the rolling cache against the full-budget cache,
    the planes' lengths and bytes, the prefill's launches; the windowed
    forward at the prefill's shape against its plain version."""
    import gc

    from tfde_tpu_torch.inference.decode import generate, init_cache
    from tfde_tpu_torch.models.gpt import GPT

    model = GPT(**fields, dtype=torch.float32, device=dev, seed=0)
    window = fields["sliding_window"]
    prompt = np.random.default_rng(3).integers(0, model.vocab_size,
                                               (1, RC_PROMPT))
    total = RC_PROMPT + RC_NEW
    rolling = init_cache(model, 1, total, rolling=True)
    full = init_cache(model, 1, total)
    lens = [k.shape[1] for k in rolling.keys]
    local = [n for i, n in enumerate(lens) if i % 2 == 0]
    glob = [n for i, n in enumerate(lens) if i % 2 == 1]
    if set(local) != {window} or set(glob) != {total}:
        raise AssertionError(f"decoding: rolling planes {lens}")
    nbytes = {name: sum(t.numel() * t.element_size()
                        for t in c.planes().values())
              for name, c in (("rolling", rolling), ("full", full))}
    print(f"decoding rolling cache (Gemma-2-2B fp32, batch 1, {total} "
          f"cells): {len(local)} local layers' planes hold {window} "
          f"positions, {len(glob)} global layers' {total}; cache bytes "
          f"rolling {nbytes['rolling']}, full {nbytes['full']}")
    del rolling
    _zero_counts(fa)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got, _ = generate(model, prompt, RC_NEW, device=dev)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if fa.flash_forward.launches != model.depth:
        raise AssertionError(f"decoding: the rolling prefill launched the "
                             f"forward {fa.flash_forward.launches} times")
    with torch.no_grad():
        tok = model.head(model.hidden(torch.as_tensor(prompt, device=dev),
                                      cache=full)[:, -1]).argmax(-1)
        want = [tok]
        for _ in range(RC_NEW - 1):
            want.append(model(want[-1][:, None], cache=full)[:, -1]
                        .argmax(-1))
    if not torch.equal(got[:, RC_PROMPT:], torch.stack(want, dim=1)):
        raise AssertionError("decoding: rolling generate differs from the "
                             "full-budget cache")
    print(f"decoding rolling generate: {RC_PROMPT} + {RC_NEW} tokens equal "
          f"the full-budget cache's; flash_fwd {model.depth} launches in the "
          f"prefill ({model.depth // 2} windowed over the {RC_PROMPT}-token "
          f"prompt); {dt:.3f} s")
    del model, full
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(9)
    h, kv, d = fields["num_heads"], fields["num_kv_heads"], fields["head_dim"]
    opts = (True, window, fields["attn_scale"], fields["attn_logit_cap"])
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((1, RC_PROMPT, h, d), generator=gen,
                        device=dev).to(dtype)
        k, v = (torch.randn((1, RC_PROMPT, kv, d), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        out, lse = fa.flash_forward(q, k, v, *opts)
        torch.cuda.synchronize(dev)
        ref_out, ref_lse = fa.flash_forward_reference(q, k, v, *opts)
        out_rel = _rel(out.float(), ref_out.float())
        lse_err = float((lse - ref_lse).abs().max())
        tol_out, tol_lse = TOL[dtype]
        ok = (bool(torch.isfinite(out).all()) and out_rel <= tol_out
              and lse_err <= tol_lse)
        print(f"kernel flash_fwd rolling prefill [1, {RC_PROMPT}, {h} -> "
              f"{kv}, {d}] {str(dtype).split('.')[-1]} window {window} cap "
              f"{opts[3]} scale {opts[2]}: out rel {out_rel:.3e} (tol "
              f"{tol_out:g}), lse max abs {lse_err:.3e} (tol {tol_lse:g}) "
              f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_fwd disagrees with its plain version "
                                 "at the rolling prefill shape")
        del q, k, v, out, lse, ref_out, ref_lse


def phase_decoding(fa, dev):
    """The decoding modes (docstring, phase 18)."""
    import gc

    from tfde_tpu_torch import testing

    print(f"decoding on {_card()}")
    llama = testing.FULL_WIDTH["Llama-3.2-1B"][1]
    bf16 = _dc_batcher(fa, dev, llama)
    _dc_beam(fa, dev, llama, bf16)
    del bf16
    gc.collect()
    torch.cuda.empty_cache()
    _dc_rolling(fa, dev, testing.FULL_WIDTH["Gemma-2-2B"][1])
    gc.collect()
    torch.cuda.empty_cache()


#: router: Llama-3.2-1B (published widths, random weights from seed 0,
#: fp32) behind two decode-capable replicas (batch RT_BATCH, max_len
#: RT_MAX_LEN) and a prefill replica (batch 1), a Router priming prompts
#: of RT_PREFILL_MIN tokens or more; RT_REQUESTS requests of RT_PROMPT
#: tokens x RT_NEW new in parallel threads (RT_NEW 16 until a slow card
#: host ran the phase in 129.0 s: the solo references dominate there)
RT_BATCH, RT_MAX_LEN, RT_PREFILL_MIN = 4, 512, 256
RT_REQUESTS, RT_PROMPT, RT_NEW = 12, (32, 400), 8
#: re-routed requests, sequential hop-cost requests, the profiled
#: requests (one wave of RT_BATCH, RT_PROFILE_NEW new each: the window,
#: RT_SPAN decode rounds, opens after their first step and closes after
#: the second, so it holds decode ticks only), the HTTP calls' timeout (s)
RT_REROUTE, RT_HOPS, RT_TIMEOUT = 4, 2, 120
RT_PROFILED, RT_PROFILE_NEW, RT_SPAN = 4, 16, 4
#: the child replica (`python -m` argv), the child that prints the sha256
#: of the same seeded weights, and the profiler's category of a CUDA
#: kernel in its Chrome trace
RT_CHILD = ("tfde_tpu_torch.serve_gpt", "--serve", "0", "--seed", "0")
RT_DIGEST = ("from tfde_tpu_torch.models.gpt import GPT2Small; "
             "from tfde_tpu_torch.testing import state_digest; "
             "print(state_digest(GPT2Small(device='cuda', seed=0)"
             ".cast_compute_weights_()))")
RT_KERNEL_CAT = "kernel"


def _rt_ms(xs) -> str:
    xs = sorted(xs)
    return (f"median {xs[len(xs) // 2] * 1e3:.1f} ms, max "
            f"{xs[-1] * 1e3:.1f} ms")


def _rt_through(router_url, prompts, n=RT_NEW):
    """Every prompt through `request_generate` (`n` new tokens) in
    parallel threads: (results, end-to-end seconds each)."""
    from tfde_tpu_torch.inference.router import request_generate

    def one(p):
        t0 = time.perf_counter()
        out = request_generate(router_url, p, n, timeout=RT_TIMEOUT)
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(len(prompts)) as pool:
        res = list(pool.map(one, prompts))
    return [r[0] for r in res], [r[1] for r in res]


def _rt_hold(what, outs, prompts, want):
    diff = [i for i, (o, p) in enumerate(zip(outs, prompts))
            if o["tokens"] != want[p.tobytes()]]
    if diff:
        raise AssertionError(f"router {what}: requests {diff} differ from "
                             f"their solo generate")


def _rt_parity(fa, dev, model, router, reps, pre, prompts, want):
    """Drill 1: the requests through the front door against solo
    `generate`, their placement, the prefill tier's hand-offs and the
    phase's flash launches; then TTFT through the router against the
    batcher in-process."""
    from tfde_tpu_torch.inference.router import request_generate
    from tfde_tpu_torch.inference.server import ContinuousBatcher

    primes = []
    prime = pre.batcher.prime
    pre.batcher.prime = lambda *a, **kw: (primes.append(1), prime(*a, **kw))[1]
    torch.cuda.synchronize(dev)
    _zero_counts(fa)
    t0 = time.perf_counter()
    outs, e2e = _rt_through(router.url, prompts)
    wall = time.perf_counter() - t0
    launches = fa.flash_forward.launches
    pre.batcher.prime = prime
    _rt_hold("parity", outs, prompts, want)
    placed = sorted({o["replica"] for o in outs})
    if placed != [0, 1]:
        raise AssertionError(f"router: placement used replicas {placed}")
    n_long = sum(int(p.size) >= RT_PREFILL_MIN for p in prompts)
    with reps[0].lock, reps[1].lock:
        waves = [r.batcher.wave_counts() for r in reps]
    cold = sum(w.get("cold", 0) for w in waves)
    primed = sum(w.get("primed", 0) for w in waves)
    if len(primes) != n_long or not primed:
        raise AssertionError(f"router: {len(primes)} primes and {primed} "
                             f"primed waves for {n_long} long prompts")
    want_launches = model.depth * (cold + len(primes))
    if launches != want_launches:
        raise AssertionError(
            f"router: flash_fwd launched {launches} times, not "
            f"{model.depth} x ({cold} cold waves + {len(primes)} primes)")
    ttft = [o["ttft_s"] for o in outs]
    print(f"router parity: {len(prompts)} requests in parallel in "
          f"{wall:.3f} s, every token equal to solo generate; replicas "
          f"{[o['replica'] for o in outs]}; {n_long} prompts of >= "
          f"{RT_PREFILL_MIN} tokens primed on the prefill replica, decoded "
          f"in {primed} primed waves beside {cold} cold waves; flash_fwd "
          f"{launches} launches ({model.depth} a cold wave and a prime, 0 a "
          f"primed wave); TTFT through the router {_rt_ms(ttft)}; end to "
          f"end {_rt_ms(e2e)} a request")
    # the same requests submitted at once to one batcher of a replica's
    # width, in-process (no HTTP, no SSE, no router, no prefill tier)
    direct = ContinuousBatcher(model, batch_size=RT_BATCH,
                               max_len=RT_MAX_LEN, device=dev)
    for p in prompts:
        direct.submit(p, RT_NEW)
    direct.run()
    torch.cuda.synchronize(dev)
    print(f"router parity: the same {len(prompts)} requests at once into "
          f"one in-process batcher (batch {RT_BATCH}): TTFT "
          f"{_rt_ms([v / 1e3 for v in direct.ttft_ms().values()])}")
    # the hops' cost: one request at a time, through the router and
    # directly (submit, then steps until its first token is taken)
    short = [p for p in prompts if p.size < RT_PREFILL_MIN][:RT_HOPS]
    direct.enable_progress()
    via, own = [], []
    for p in short:
        via.append(request_generate(router.url, p, RT_NEW,
                                    timeout=RT_TIMEOUT)["ttft_s"])
        t0 = time.perf_counter()
        rid = direct.submit(p, RT_NEW)
        while not direct.take_progress(rid)[0]:
            direct.step()
        own.append(time.perf_counter() - t0)
        direct.run()
        direct.take_progress(rid)
    print(f"router hops: {len(short)} requests one at a time (prompts "
          f"{[int(p.size) for p in short]}), TTFT through the router "
          f"{_rt_ms(via)}, in-process {_rt_ms(own)}: the HTTP, SSE and "
          f"router hops cost {(sum(via) - sum(own)) / len(short) * 1e3:.1f} "
          f"ms a request")
    del direct
    return launches


def _rt_reroute(router, reps, prompts, want):
    """Drill 2: replica 0's front door shut; the next requests land on
    replica 1 with equal tokens, and replica 0 is down."""
    from tfde_tpu_torch.inference.router import request_generate
    from tfde_tpu_torch.observability import flightrec, metrics

    reg = metrics.default_registry()
    lost = reg.counter("router/replicas_lost").value
    reps[0]._httpd.shutdown()
    reps[0]._httpd.server_close()
    outs = [request_generate(router.url, p, RT_NEW, timeout=RT_TIMEOUT)
            for p in prompts]
    if any(o["replica"] != 1 for o in outs):
        raise AssertionError(f"router re-route: placed on "
                             f"{[o['replica'] for o in outs]}")
    _rt_hold("re-route", outs, prompts, want)
    tab = {row["replica"]: row for row in router.table()}
    kinds = [e["kind"] for e in flightrec.default_recorder().events()]
    if (reg.counter("router/replicas_lost").value < lost + 1
            or reg.gauge("router/replica0/up").value != 0
            or tab[0]["up"] or "replica_down" not in kinds):
        raise AssertionError(f"router re-route: replica 0 not marked down "
                             f"({tab[0]})")
    print(f"router re-route: replica 0's front door shut; the next "
          f"{len(prompts)} requests all on replica 1, tokens equal to solo "
          f"generate; router/replicas_lost "
          f"{reg.counter('router/replicas_lost').value:.0f}, "
          f"router/replica0/up 0, replica_down in the flight ring")


def _rt_spawn(root):
    """Start the `serve_gpt --serve 0` child (RT_CHILD), the child that
    prints the sha256 of the same seeded weights (RT_DIGEST), and a
    thread that notes when the child's URL is logged and its /healthz
    first reads ready: (child, digest child, the child's stderr log, the
    thread, its findings {"url", "ready_s", "healthz"})."""
    import threading
    import urllib.request

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    log = os.path.join(root, "serve_child.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        child = subprocess.Popen([sys.executable, "-m", *RT_CHILD], env=env,
                                 cwd=here, stdout=subprocess.DEVNULL,
                                 stderr=f)
    digest = subprocess.Popen([sys.executable, "-c", RT_DIGEST], env=env,
                              cwd=here, stdout=subprocess.PIPE, text=True)
    seen = {}

    def watch():
        while child.poll() is None and time.perf_counter() - t0 < 600:
            with open(log) as f:
                for line in f:
                    if "replica serving on " in line:
                        seen["url"] = line.split(
                            "replica serving on ")[1].split()[0]
            if "url" in seen:
                hz = json.loads(urllib.request.urlopen(
                    seen["url"] + "/healthz", timeout=30).read())
                if hz.get("state") == "ready":
                    seen["ready_s"] = time.perf_counter() - t0
                    seen["healthz"] = hz
                    return
            time.sleep(0.05)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    return child, digest, log, watcher, seen


def _rt_child(dev, spawned):
    """Drill 3: the `python -m tfde_tpu_torch.serve_gpt --serve 0` child
    (GPT-2 small, random weights from --seed 0; started with the phase,
    `_rt_spawn`) next to an in-process replica of the same seeded model
    behind one Router; its request, and after a SIGKILL the survivor's,
    equal the in-process replica's tokens for the same prompt."""
    from tfde_tpu_torch import testing
    from tfde_tpu_torch.inference.router import (ReplicaServer, Router,
                                                 request_generate)
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.models.gpt import GPT2Small

    child, digest, log, watcher, seen = spawned
    local = router = None
    try:
        model = GPT2Small(device=dev, seed=0).cast_compute_weights_()
        # serve_gpt's batcher: batch 4, max_len 128, scan depth 4
        local = ReplicaServer(ContinuousBatcher(
            model, batch_size=4, max_len=128, scan_depth=4,
            generator=torch.Generator(device=dev).manual_seed(0),
            device=dev), replica_id=1).start()
        mine = testing.state_digest(model)
        theirs = digest.communicate(timeout=600)[0].strip().splitlines()[-1]
        if theirs != mine:
            raise AssertionError(f"router child: --seed 0 weights differ "
                                 f"between processes ({theirs} vs {mine})")
        watcher.join(timeout=600)
        if "ready_s" not in seen:
            with open(log) as f:
                raise AssertionError(f"router child did not serve:\n"
                                     f"{f.read()[-4000:]}")
        url = seen["url"]
        print(f"router child: serve_gpt --serve 0 ready at {url} in "
              f"{seen['ready_s']:.1f} s (process start to /healthz "
              f"{seen['healthz']}; it started with the phase and booted "
              f"while this process built its model and ran drills 1-2); "
              f"--seed 0 "
              f"gives the same weights in two processes (sha256 of every "
              f"parameter's bytes, a second child against this process: "
              f"{mine[:16]})")
        router = Router([url, local.url]).start()
        p = np.random.default_rng(5).integers(0, model.vocab_size, 48)
        ref = request_generate(local.url + "/generate", p, RT_NEW,
                               timeout=RT_TIMEOUT)["tokens"]
        out = request_generate(router.url, p, RT_NEW, timeout=RT_TIMEOUT)
        if out["replica"] != 0 or out["tokens"] != ref:
            raise AssertionError(f"router child: {out} against {ref}")
        solo = _dc_solo(model, p, RT_NEW, dev).tolist()
        child.kill()
        child.wait(timeout=60)
        after = [request_generate(router.url, p, RT_NEW, timeout=RT_TIMEOUT)
                 for _ in range(2)]
        if any(o["replica"] != 1 or o["tokens"] != ref for o in after):
            raise AssertionError(f"router child: after the SIGKILL {after}")
        if router.table()[0]["up"]:
            raise AssertionError("router child: the killed child is not down")
        print(f"router child: one request on the child, tokens equal to "
              f"the in-process replica's run of the same prompt (bf16; "
              f"solo generate {'equal' if solo == ref else 'differs'}); "
              f"SIGKILL: the child marked down, the next {len(after)} "
              f"requests on the survivor with equal tokens")
        return local
    finally:
        for proc in (child, digest):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if router is not None:
            router.close()


def _rt_overload(dev, model, prompt, want):
    """Drill 4: a replica capped at one queued request answers a burst
    with 429s; with it saturated the Router rejects at the front door."""
    import urllib.error
    import urllib.request

    from tfde_tpu_torch.inference import admission
    from tfde_tpu_torch.inference.router import (ReplicaServer, Router,
                                                 request_generate)
    from tfde_tpu_torch.inference.server import ContinuousBatcher

    b = ContinuousBatcher(model, batch_size=1, max_len=RT_MAX_LEN,
                          admission_ctl=admission.AdmissionController(
                              max_queue=1), device=dev)
    rep = ReplicaServer(b, replica_id=0).start()
    router = Router([rep.url]).start()
    step = b.step
    first = None
    try:
        b.step = lambda: time.sleep(0.01)   # decode stalled: the queue holds
        body = json.dumps({"prompt": prompt.tolist(),
                           "max_new_tokens": RT_NEW}).encode()

        def post():
            req = urllib.request.Request(
                rep.url + "/generate", data=body,
                headers={"Content-Type": "application/json"})
            return urllib.request.urlopen(req, timeout=RT_TIMEOUT)

        first = post()
        first.readline()                    # the one queued request
        codes = []
        with ThreadPoolExecutor(7) as pool:
            def burst(_):
                try:
                    post().close()
                    return 200, None, None
                except urllib.error.HTTPError as e:
                    return e.code, e.headers.get("Retry-After"), \
                        json.loads(e.read())
            codes = list(pool.map(burst, range(7)))
        if any(c != 429 or int(ra) < 1 or js.get("error") != "queue full"
               or js.get("reason") != "queue_depth" for c, ra, js in codes):
            raise AssertionError(f"router overload: the burst got {codes}")
        t0 = time.perf_counter()
        try:
            request_generate(router.url, prompt, RT_NEW, timeout=RT_TIMEOUT)
            raise AssertionError("router overload: the saturated router "
                                 "served")
        except urllib.error.HTTPError as e:
            fast = time.perf_counter() - t0
            js = json.loads(e.read())
            if (e.code != 429 or js.get("reason") != "saturated"
                    or int(e.headers.get("Retry-After")) < 1):
                raise AssertionError(f"router overload: {e.code} {js}")
        b.step = step
        toks = [json.loads(line[6:])["token"] for line in first
                if line.startswith(b"data: ") and b'"token"' in line]
        if toks != want:
            raise AssertionError(f"router overload: the queued request's "
                                 f"tokens {toks} differ from solo generate")
        print(f"router overload: a replica capped at one queued request "
              f"answered a burst of {len(codes)} with 429 (Retry-After "
              f"{sorted({int(c[1]) for c in codes})} s, body "
              f"{codes[0][2]}); the router in front of it rejected with 429 "
              f"'saturated' in {fast * 1e3:.1f} ms; the queued request's "
              f"tokens equal solo generate")
    finally:
        b.step = step
        if first is not None:
            first.close()
        router.close()
        if not rep.loop_alive:
            raise AssertionError("router overload: the step loop died")
        rep.close()


def _rt_trace(router, prompt, want):
    """Drill 5: one long-prompt request's stitched waterfall from
    GET {router}/trace/<id>."""
    import urllib.request

    from tfde_tpu_torch.inference.router import request_generate
    from tfde_tpu_torch.observability import trace

    trace.enable()
    try:
        out = request_generate(router.url, prompt, RT_NEW,
                               timeout=RT_TIMEOUT)
        doc = json.loads(urllib.request.urlopen(
            f"{router.url}/trace/{out['trace']}", timeout=30).read())
    finally:
        trace.disable()
    if out["tokens"] != want:
        raise AssertionError("router trace: tokens differ from solo generate")
    evs = doc["events"]
    first = {}
    for e in evs:
        first.setdefault(e["name"], e)
    need = ("router/request", "router/prime", "serve/prime",
            "router/attempt", "serve/queued", "serve/prefill_primed",
            "serve/first_token", "serve/decode_round", "serve/done",
            "serve/stream_out", "router/done")
    missing = [n for n in need if n not in first]
    if missing:
        raise AssertionError(f"router trace: no {missing} in "
                             f"{[e['name'] for e in evs]}")

    def start(n):
        return first[n]["ts"]

    def end(n):
        return first[n]["ts"] + first[n].get("dur", 0.0)

    # causal order: the request, the prime round trip around the
    # replica's prime, the placement, the queue, the primed wave, the
    # rounds, the stream out inside the router's whole
    order = [start("router/request") <= start("router/prime")
             <= start("serve/prime"), end("serve/prime") <= end("router/prime")
             <= start("router/attempt") + 1e-3,
             start("serve/queued") <= start("serve/prefill_primed")
             <= start("serve/decode_round"),
             end("serve/decode_round") <= end("serve/done") + 1e-3,
             end("serve/stream_out") <= end("router/done") + 1e-3]
    if not all(order):
        raise AssertionError(f"router trace: out of order {order}")
    rounds = [e for e in evs if e["name"] == "serve/decode_round"]
    ft = first["serve/first_token"]
    relay = (first["router/done"]["dur"] - first["router/prime"]["dur"]
             - first["serve/stream_out"]["dur"])
    print(f"router trace: prompt {prompt.size} tokens, "
          f"{len(evs)} events from {doc['procs']}: router/prime "
          f"{first['router/prime']['dur'] * 1e3:.1f} ms (serve/prime "
          f"{first['serve/prime']['dur'] * 1e3:.1f} ms of it), queue "
          f"{ft['queue_wait_ms']:.1f} ms, primed wave "
          f"{first['serve/prefill_primed']['dur'] * 1e3:.1f} ms, first "
          f"token {ft['ttft_ms']:.1f} ms after submit, {len(rounds)} decode "
          f"rounds {sum(e['dur'] for e in rounds) * 1e3:.1f} ms, "
          f"serve/stream_out {first['serve/stream_out']['dur'] * 1e3:.1f} "
          f"ms, router/done {first['router/done']['dur'] * 1e3:.1f} ms "
          f"(the router's own relay and placement {relay * 1e3:.1f} ms)")


def _rt_profile(router, reps, pre, prompts, want, model_dir):
    """Drill 6: POST {router}/profile {"span": RT_SPAN} just before the
    requests arrive (a window opens at the first decode round with work,
    so the capture holds their rounds): replica 1 captures, the prefill
    replica (same process) refuses with 409; the window's kernels and
    device-busy share."""
    import urllib.request

    from tfde_tpu_torch.observability import profiler

    req = urllib.request.Request(
        router.url + "/profile",
        data=json.dumps({"span": RT_SPAN, "reason": "router_phase"})
        .encode(), headers={"Content-Type": "application/json"})
    # replica 1's steps, timed: (ticks after, ticks run, decode seconds)
    b, steps = reps[1].batcher, []
    step = b.step

    def timed():
        t0, d0 = b._rounds, b._decode_s
        out = step()
        steps.append((b._rounds, b._rounds - t0, b._decode_s - d0))
        return out

    with reps[1].lock:
        b.step = timed
    arm = json.loads(urllib.request.urlopen(req, timeout=30).read())
    outs, _ = _rt_through(router.url, prompts, RT_PROFILE_NEW)
    with reps[1].lock:
        del b.step
    _rt_hold("profile", outs, prompts, want)
    # the fan-out's order: replica 0 (down: an error), replica 1, the
    # prefill replica (a 409 body: no error)
    dead, r1, pr = arm["replicas"]
    if ("error" not in dead or r1.get("armed") is not True
            or pr.get("armed") is not False or "error" in pr):
        raise AssertionError(f"router profile: {arm}")
    deadline = time.perf_counter() + 60
    while (not profiler.list_artifacts(model_dir[1])
           and time.perf_counter() < deadline):
        time.sleep(0.05)
    (rec,) = profiler.list_artifacts(model_dir[1])
    if profiler.list_artifacts(model_dir[2]):
        raise AssertionError("router profile: the prefill replica captured")
    with open(rec["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == RT_KERNEL_CAT]
    if not kern:
        raise AssertionError("router profile: no CUDA kernel in the window")
    by_name = {}
    for e in kern:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    spans, busy, t_end = sorted((e["ts"], e["ts"] + e["dur"]) for e in kern), \
        0.0, None
    for a, b in spans:
        if t_end is None or a > t_end:
            busy += b - a
            t_end = b
        elif b > t_end:
            busy += b - t_end
            t_end = b
    wall_us = rec["wall_s"] * 1e6
    # the window holds the decode of the steps that ended past its first
    # round up to its last; the drill's other steps ran unprofiled
    inside = [rec["start"] < after <= rec["stop"] for after, _, _ in steps]
    n_win = sum(n for (_, n, _), i in zip(steps, inside) if i)
    n_out = sum(n for (_, n, _), i in zip(steps, inside) if not i)
    plain_ms = 1e3 * sum(d for (_, _, d), i in zip(steps, inside)
                         if not i) / max(n_out, 1)
    prof_ms = 1e3 * sum(d for (_, _, d), i in zip(steps, inside)
                        if i) / max(n_win, 1)
    print(f"router profile: replica 1 captured rounds {rec['start']}-"
          f"{rec['stop']} ({len(rec['traces'])} traces), the prefill "
          f"replica refused (409, one window a process); "
          f"{rec['trace_file']} {os.path.getsize(rec['trace_file'])} bytes, "
          f"{len(kern)} kernels; device busy {busy / 1e3:.2f} ms of a "
          f"{wall_us / 1e3:.2f} ms window ({busy / wall_us:.3f} busy, "
          f"{1 - busy / wall_us:.3f} idle; an observation of the decode "
          f"rounds, ticks of Llama-3.2-1B fp32 at batch {RT_BATCH}); the "
          f"drill's {n_out} ticks outside the window took {plain_ms:.2f} "
          f"ms a tick of decode, its {n_win} inside {prof_ms:.2f}: with "
          f"the device's {busy / 1e3 / max(n_win, 1):.2f} ms a tick "
          f"unchanged, busy {busy / 1e3 / max(n_win, 1) / plain_ms:.3f} "
          f"of an unprofiled tick")
    for name, us in top:
        print(f"router profile kernel: {us / 1e3:9.3f} ms  {name[:110]}")


def phase_router(fa, dev):
    """The serving front door (docstring, phase 19)."""
    import gc
    import shutil
    import tempfile

    from tfde_tpu_torch import testing
    from tfde_tpu_torch.inference.router import ReplicaServer, Router
    from tfde_tpu_torch.inference.server import ContinuousBatcher
    from tfde_tpu_torch.models.gpt import GPT
    from tfde_tpu_torch.observability import profiler

    print(f"router on {_card()}")
    root = tempfile.mkdtemp(prefix="router_phase_")
    dirs = [os.path.join(root, name) for name in ("r0", "r1", "pre")]
    # the child replica starts first and boots while this process works
    spawned = _rt_spawn(root)
    # the automatic captures (an SLO burn crossing of the router's
    # tracker arms whichever replica's sink the hub asks first) are off,
    # so the one profiler window of the process is the profile drill's
    hub = profiler.hub()
    hub.enabled = False
    servers, router = [], None
    try:
        fields = testing.FULL_WIDTH["Llama-3.2-1B"][1]
        model = GPT(**fields, dtype=torch.float32, device=dev, seed=0)
        prompts = _dc_prompts(model.vocab_size, RT_REQUESTS, *RT_PROMPT,
                              seed=2)
        extra = _dc_prompts(model.vocab_size, RT_REROUTE + RT_PROFILED, 32,
                            200, seed=3)
        longp = _dc_prompts(model.vocab_size, 1, 300, 400, seed=4)
        want = {p.tobytes(): _dc_solo(model, p, RT_NEW, dev).tolist()
                for p in prompts + extra[:RT_REROUTE] + longp}
        want.update({p.tobytes(): _dc_solo(model, p, RT_PROFILE_NEW,
                                           dev).tolist()
                     for p in extra[RT_REROUTE:]})
        print(f"router: Llama-3.2-1B (published widths, random weights "
              f"from seed 0, fp32, one module shared by every replica: its "
              f"forward keeps no state on the module); two replicas (batch "
              f"{RT_BATCH}, max_len {RT_MAX_LEN}) and a prefill replica "
              f"(batch 1) behind a Router (prefill_min_tokens "
              f"{RT_PREFILL_MIN}); prompt lengths "
              f"{[int(p.size) for p in prompts]} x {RT_NEW} new")
        reps = [ReplicaServer(ContinuousBatcher(
                    model, batch_size=RT_BATCH, max_len=RT_MAX_LEN,
                    device=dev), replica_id=i, model_dir=dirs[i]).start()
                for i in range(2)]
        pre = ReplicaServer(ContinuousBatcher(
            model, batch_size=1, max_len=RT_MAX_LEN, role="prefill",
            device=dev), replica_id=0, model_dir=dirs[2]).start()
        servers = reps + [pre]
        router = Router([r.url for r in reps], prefill_replicas=[pre.url],
                        prefill_min_tokens=RT_PREFILL_MIN).start()
        launches = _rt_parity(fa, dev, model, router, reps, pre, prompts,
                              want)
        _rt_reroute(router, reps, extra[:RT_REROUTE], want)
        servers.append(_rt_child(dev, spawned))
        _rt_overload(dev, model, extra[0], want[extra[0].tobytes()])
        _rt_trace(router, longp[0], want[longp[0].tobytes()])
        _rt_profile(router, reps, pre, extra[RT_REROUTE:], want, dirs)
        dead = [s for s in servers if not s.loop_alive]
        if dead:
            raise AssertionError(f"router: {len(dead)} step loops died")
        print(f"router end: all {len(servers)} step loops alive")
    finally:
        for proc in spawned[:2]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        hub.enabled = True
        if router is not None:
            router.close()
        for s in servers:
            try:
                s.close()
            except OSError:
                pass  # replica 0's front door was shut by the re-route drill
        shutil.rmtree(root, ignore_errors=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print("router end: every server closed")
    return launches


#: moe (a): the layer on the card against the CPU in fp32 — output and
#: losses relative Frobenius (the same sums in another order), gradients
#: relative Frobenius tensor by tensor (`_grads_rel`)
MOE_TOL = {"out": 1e-5, "loss": 1e-5, "grad": 1e-4}
#: moe (a): the same layer computing in bf16 against itself in fp32 on one
#: bf16-valued input (the same routing): output and every gradient,
#: relative Frobenius. The bf16 path rounds the expert weights, each
#: product's output and the activations to bf16 (~2e-3 each, 8 bits of
#: mantissa), so a few times that; a missing or misrouted term of the
#: backward is O(1)
MOE_BF16_TOL = 3e-2
#: moe (a): the two layers, as `MoEMlp` keyword arguments, and their input
#: [groups, tokens a group]: Qwen1.5-MoE-A2.7B's (60 swiglu experts of
#: 1408, top-4 with raw gates, the shared expert of 5632, dropless) and
#: gpt_lm --moe 8's at GPT-2 small width (8 gelu + bias experts of 3072,
#: top-2, capacity 1.25: choices drop)
MOE_LAYERS = {
    "Qwen1.5-MoE-A2.7B": (dict(embed=2048, num_experts=60, mlp_dim=1408,
                               experts_per_token=4, capacity_factor=15.0,
                               act="swiglu", use_bias=False,
                               normalize_topk=False,
                               shared_expert_dim=5632), (2, 192)),
    "gpt_lm --moe 8": (dict(embed=768, num_experts=8, mlp_dim=3072,
                            experts_per_token=2, capacity_factor=1.25),
                       (2, 256)),
}
#: moe (b): Qwen1.5-MoE-A2.7B in fp32 at depth MOE_FP32_DEPTH behind a
#: batcher (batch 4, max_len 256, scan depth 4): MOE_FP32_REQUESTS requests
#: of 16-180 prompt tokens (every other one after a shared 64-token
#: system prompt) x MOE_FP32_NEW
MOE_FP32_DEPTH, MOE_FP32_REQUESTS, MOE_FP32_NEW = 2, 6, 8
#: moe (c): Qwen1.5-MoE-A2.7B at full depth in bf16: 16 requests of 16-960
#: prompt tokens x MOE_NEW, batch 8, max_len 1024, scan depth 4
MOE_NEW = 32
#: moe (d): the Mixtral-8x7B-v0.1 artifact's depth (32 published: its
#: 46.7 B parameters would be 93 GB in bf16) and serve_gpt's new tokens
MOE_MIXTRAL_DEPTH, MOE_MIXTRAL_NEW = 2, 8
#: moe (e): gpt_lm --moe 8 steps, in bf16 and again in fp32. The
#: objective is the cross-entropy plus the six blocks' load-balance
#: losses, and the latter grows while the routers learn (0.077 -> 0.226
#: in the first 9 steps on an H100), so the cross-entropy is the series
#: held falling
MOE_GL_STEPS = 10
#: moe (e): the largest difference of a step's cross-entropy between the
#: bf16 and the fp32 run of the same 10 steps (the same data and initial
#: weights; bf16 rounding carried through 10 AdamW updates and the
#: routing choices it flips)
MOE_GL_CE_TOL = 5e-2
#: the forward kernel at the MoE models' prefills, [B, S, H, D] and KV
#: heads
MOE_PREFILL = {"Qwen1.5-MoE-A2.7B": ((1, 4096, 16, 128), 16),
               "Mixtral-8x7B-v0.1": ((1, 4096, 32, 128), 8)}
#: moe (c): the prefill waves timed in each expert-buffer layout: the
#: first 8 of (c)'s prompts cut to these lengths (their buckets); the
#: timed calls of a decode tick and of one layer in each layout
MOE_LAYOUT_WAVES, MOE_TICK_ITERS = (128, 512, 1024), 5


class _moe_forced:
    """Inside, every MoE layer takes the expert-buffer `layout` ('padded'
    or 'sorted') whatever its own rule (`moe.expert_layout`) says."""

    def __init__(self, layout: str):
        self.layout = layout

    def __enter__(self):
        from tfde_tpu_torch.models import moe as moe_lib

        self.natural = moe_lib.expert_layout
        moe_lib.expert_layout = lambda *a: self.layout

    def __exit__(self, *exc):
        from tfde_tpu_torch.models import moe as moe_lib

        moe_lib.expert_layout = self.natural


def _moe_route(layer, x, groups):
    """The routed experts of every token of `x` ([groups, m, k])."""
    from tfde_tpu_torch.models.moe import top_k

    with torch.no_grad():
        tokens = x.reshape(groups, -1, x.shape[-1]).float()
        probs = torch.softmax(layer.router(tokens), dim=-1)
        return top_k(probs, layer.experts_per_token)[1].sort(-1).values


def _moe_layer_run(layer, x, r, keep):
    """Output (on the CPU), losses and gradients (on the layer's device)
    of sum((y r)[kept groups]) + the losses through `layer`."""
    layer.zero_grad(set_to_none=True)
    x = x.clone().requires_grad_(True)
    losses = {}
    y = layer(x, losses=losses)
    total = {k: sum(v) for k, v in losses.items()}
    ((y * r)[keep].sum() + sum(total.values())).backward()
    grads = {n: p.grad.detach() for n, p in layer.named_parameters()}
    grads["input"] = x.grad.detach()[keep]
    return (y.detach()[keep].cpu(),
            {k: float(v.detach()) for k, v in total.items()}, grads)


def _moe_layer(dev):
    """(a) One MoE layer on the card against the same weights on the CPU,
    fp32, through both expert-buffer layouts: output, losses, gradients.
    Groups where a token's routed experts differ between the two sides (a
    near-tie the rounding flips) are counted and left out of the
    comparison."""
    from tfde_tpu_torch.models import moe as moe_lib

    for label, (kw, (groups, m)) in MOE_LAYERS.items():
        gen = torch.Generator(device=dev).manual_seed(11)
        card = moe_lib.MoEMlp(**kw, dtype=torch.float32, device=dev)
        d = kw["embed"]
        with torch.no_grad():
            for p in card.parameters():
                p.normal_(0.0, 0.02, generator=gen)
            # router logits of unit scale over unit-scale tokens
            card.router.weight.normal_(0.0, d ** -0.5, generator=gen)
        cpu = moe_lib.MoEMlp(**kw, dtype=torch.float32, device="cpu")
        cpu.load_state_dict(card.state_dict())
        x = torch.randn((groups, m, d), generator=gen, device=dev).cpu()
        r = torch.randn((groups, m, d), generator=gen, device=dev).cpu()
        flipped = (_moe_route(card, x.to(dev), groups).cpu()
                   != _moe_route(cpu, x, groups)).any(-1)
        keep = ~flipped.any(-1)
        if not bool(keep.any()):
            raise AssertionError(f"moe layer {label}: every group flipped")
        want = _moe_layer_run(cpu, x, r, keep)
        # compared on the card: the expert gradients are ~2 GB at Qwen's
        # width
        want = (want[0], want[1], {n: t.to(dev) for n, t in want[2].items()})
        n_kept = m * kw["experts_per_token"]
        layout = moe_lib.expert_layout(
            kw["num_experts"], groups * min(moe_lib.group_capacity(
                m, kw["num_experts"], kw["experts_per_token"],
                kw["capacity_factor"]), m), groups * n_kept)
        for forced in ("padded", "sorted"):
            with _moe_forced(forced):
                got = _moe_layer_run(card, x.to(dev), r.to(dev),
                                     keep.to(dev))
                torch.cuda.synchronize(dev)
            out_rel = _rel(got[0], want[0])
            loss_rel = max(abs(got[1][k] - v) / abs(v)
                           for k, v in want[1].items())
            grad_rel = _grads_rel(got[2], want[2])
            print(f"moe layer {label} ({json.dumps(kw)}), fp32, "
                  f"{groups} groups x {m} tokens, the '{forced}' layout"
                  f"{' (its own)' if forced == layout else ''}: routing "
                  f"flipped for {int(flipped.sum())} of {groups * m} tokens "
                  f"({int((~keep).sum())} groups left out); card vs CPU: "
                  f"out rel {out_rel:.3e}, losses {got[1]} (rel "
                  f"{loss_rel:.3e}), worst gradient rel {grad_rel:.3e} "
                  f"(input, router, experts{', shared' if 'shared_expert_dim' in kw else ''})")
            if not (out_rel <= MOE_TOL["out"] and loss_rel <= MOE_TOL["loss"]
                    and grad_rel <= MOE_TOL["grad"]):
                raise AssertionError(f"moe layer {label}: the card disagrees "
                                     f"with the CPU")
        # the layer in bf16 against itself in fp32 on one bf16-valued
        # input: the router reads it in fp32 either way, so both route
        # alike and every group is compared
        half = moe_lib.MoEMlp(**kw, dtype=torch.bfloat16, device=dev)
        half.load_state_dict(card.state_dict())
        xh = x.to(dev).to(torch.bfloat16)
        every = torch.ones(groups, dtype=torch.bool, device=dev)
        want = _moe_layer_run(card, xh.float(), r.to(dev), every)
        got = _moe_layer_run(half, xh, r.to(dev), every)
        out_rel = _rel(got[0], want[0])
        grad_rel = _grads_rel(got[2], want[2])
        print(f"moe layer {label}, bf16 vs fp32 on the card, the "
              f"'{layout}' layout: out rel {out_rel:.3e}, losses "
              f"{got[1]} vs {want[1]}, worst gradient rel {grad_rel:.3e} "
              f"(tol {MOE_BF16_TOL:g})")
        if not (out_rel <= MOE_BF16_TOL and grad_rel <= MOE_BF16_TOL
                and got[1] == want[1]):
            raise AssertionError(f"moe layer {label}: bf16 disagrees with "
                                 f"fp32")
        del cpu, card, half


def _moe_model(fields, dtype, dev, depth=None):
    from tfde_tpu_torch.models.gpt import GPT

    fields = dict(fields, depth=depth or fields["depth"])
    return GPT(**fields, dtype=dtype, device=dev, seed=0)


def _moe_fp32(fa, dev, fields):
    """(b) Qwen1.5-MoE-A2.7B at full width in fp32, depth cut: one wave's
    prefill logits flash vs reference, then the batcher's greedy tokens
    against solo `generate` in the dense, paged, prefix-cached and int8-KV
    layouts, each solo run in the same KV format."""
    from tfde_tpu_torch.inference.server import ContinuousBatcher

    model = _moe_model(fields, torch.float32, dev, MOE_FP32_DEPTH)
    vocab = model.vocab_size
    system = np.random.default_rng(3).integers(0, vocab, 64)
    prompts = _dc_prompts(vocab, MOE_FP32_REQUESTS, 16, 180, seed=4)
    prompts = [np.concatenate([system, p]) if i % 2 else p
               for i, p in enumerate(prompts)]
    logits = _hf_wave_logits(model, prompts[:4], dev)
    rel = _rel(logits["flash"], logits["reference"])
    print(f"moe fp32: Qwen1.5-MoE-A2.7B widths, depth {MOE_FP32_DEPTH} of "
          f"24 (cut: fp32 at full depth is 57.3 GB), random weights from "
          f"seed 0; one wave's first-token logits ({len(prompts[:4])} rows), "
          f"flash vs reference: rel {rel:.3e} (tol {HF_WAVE_TOL})")
    if not (bool(torch.isfinite(logits["flash"]).all())
            and rel <= HF_WAVE_TOL):
        raise AssertionError("moe fp32: flash and reference prefill logits "
                             "disagree")
    layouts = {"dense": {}, "paged": dict(paged=True, prefix_cache=True),
               "prefix": dict(prefix_cache=True), "int8": dict(kv_quant="int8")}
    for name, opts in layouts.items():
        model.kv_quant = "int8" if name == "int8" else None
        try:
            want = [_dc_solo(model, p, MOE_FP32_NEW, dev) for p in prompts]
            srv = ContinuousBatcher(model, batch_size=4, max_len=256,
                                    scan_depth=4, device=dev, **opts)
            torch.cuda.synchronize(dev)
            _zero_counts(fa)
            rids = [srv.submit(p, MOE_FP32_NEW) for p in prompts]
            done = dict(srv.run())
            launches = fa.flash_forward.launches
        finally:
            model.kv_quant = None
        same = sum(np.array_equal(done[r], w) for r, w in zip(rids, want))
        stats = srv.stats()
        hits = (srv.prefix_cache.stats()["hits"]
                if srv.prefix_cache is not None else 0)
        print(f"moe fp32 {name}: batcher greedy tokens == solo generate for "
              f"{same}/{len(prompts)} requests (prompts "
              f"{[int(p.size) for p in prompts]} x {MOE_FP32_NEW}); "
              f"{stats['prefill_waves']} prefill waves, flash launches "
              f"{launches}, prefix hits {hits}")
        if same != len(prompts):
            raise AssertionError(f"moe fp32 {name}: batcher tokens differ "
                                 f"from solo generate")
        if name in ("prefix", "paged") and hits == 0:
            raise AssertionError(f"moe fp32 {name}: the prefix cache never "
                                 f"hit")
    del model


def _host_ms(fn, dev, iters: int = 20) -> float:
    """Mean wall ms of `fn` over `iters` calls in a row, one synchronise
    at the end: the host's enqueue where it is slower than the card."""
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / iters


def _moe_tick_share(model, dev):
    """One bf16 decode tick of 8 rows through the whole model and one MoE
    layer on the same [8, 1, d] input, in each expert-buffer layout (the
    rule takes 'padded' there): device ms (CUDA events after an L2 flush
    and a 5 ms spin, `_time_ms`) and wall ms of calls in a row
    (`_host_ms`), each over MOE_TICK_ITERS calls."""
    from tfde_tpu_torch.inference.decode import init_cache

    tok = torch.zeros((8, 1), dtype=torch.long, device=dev)
    cache = init_cache(model, 8, 64)
    cache.index = 16
    layer = model.decoder.block_0.moe
    x = torch.randn((8, 1, model.hidden_size), device=dev).to(model.dtype)

    def tick():
        if cache.index >= 60:
            cache.index = 16
        model(tok, cache=cache)

    for layout in ("padded", "sorted"):
        with torch.no_grad(), _moe_forced(layout):
            (tick_dev, tick_wall), (moe_dev, moe_wall) = (
                (_time_ms(fn, dev, iters=MOE_TICK_ITERS),
                 _host_ms(fn, dev, iters=MOE_TICK_ITERS))
                for fn in (tick, lambda: layer(x)))
        print(f"moe bf16 tick, the '{layout}' layout: one decode tick of 8 "
              f"rows {tick_dev:.3f} ms (events), {tick_wall:.3f} ms (wall, "
              f"calls in a row); one MoE layer on [8, 1, "
              f"{model.hidden_size}] {moe_dev:.4f} ms (events), "
              f"{moe_wall:.4f} ms (wall); x {model.depth} layers = "
              f"{model.depth * moe_dev / tick_dev:.1%} (events), "
              f"{model.depth * moe_wall / tick_wall:.1%} (wall) of the "
              f"tick; on {_card()}")


def _moe_layout_waves(model, dev, prompts):
    """(c)'s first 8 prompts, each repeated or cut to every length of
    MOE_LAYOUT_WAVES, as one prefill wave through the whole model
    (`hidden` without a cache: the flash forward and the MoE layers of a
    batcher's wave) in each expert-buffer layout: ms by CUDA events,
    which take in the sorted layout's host sync a layer (the card waits
    for the host's per-expert loop) and the padded layout's extra rows."""
    from tfde_tpu_torch.models import moe as moe_lib

    cfg = model.config
    e, k = cfg["num_experts"], cfg["experts_per_token"]
    for s in MOE_LAYOUT_WAVES:
        ids = torch.as_tensor(np.stack([np.resize(p, s) for p in prompts[:8]]),
                              device=dev)
        own = moe_lib.expert_layout(e, 8 * min(moe_lib.group_capacity(
            s, e, k, cfg["moe_capacity_factor"]), s), 8 * s * k)
        ms = {}
        for layout in ("padded", "sorted"):
            with torch.no_grad(), _moe_forced(layout):
                ms[layout] = _time_ms(lambda: model.hidden(ids), dev,
                                      iters=2, warmup=1)
        torch.cuda.empty_cache()
        print(f"moe bf16 layouts: a prefill wave of [8, {s}] tokens through "
              f"the {model.depth} layers: padded {ms['padded']:.2f} ms, "
              f"sorted {ms['sorted']:.2f} ms (CUDA events); the rule takes "
              f"'{own}'; on {_card()}")


def _moe_train_layouts(dev):
    """gpt_lm --moe 8's layer (`MOE_LAYERS`) in bf16 on one step's [8,
    1024, 768] input, forward and backward, in each expert-buffer layout
    (the rule takes 'padded' there): ms by CUDA events."""
    from tfde_tpu_torch.models.moe import MoEMlp

    kw = MOE_LAYERS["gpt_lm --moe 8"][0]
    gen = torch.Generator(device=dev).manual_seed(11)
    layer = MoEMlp(**kw, dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.02, generator=gen)
        layer.router.weight.normal_(0.0, kw["embed"] ** -0.5, generator=gen)
    x = torch.randn((8, 1024, kw["embed"]), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_(True)

    def step():
        losses = {}
        y = layer(x, losses=losses)
        (y.float().square().mean() + sum(losses["moe_aux"])).backward()

    ms = {}
    for layout in ("padded", "sorted"):
        with _moe_forced(layout):
            ms[layout] = _time_ms(step, dev, iters=10)
    print(f"moe bf16 layouts: gpt_lm --moe 8's layer, forward and backward "
          f"on [8, 1024, {kw['embed']}]: padded {ms['padded']:.3f} ms, "
          f"sorted {ms['sorted']:.3f} ms (CUDA events); on {_card()}")


def _moe_bf16(fa, dev, fields):
    """(c) Qwen1.5-MoE-A2.7B at full width and depth in bf16 behind the
    batcher as in the serve phase, the counters zeroed just before."""
    import gc

    from tfde_tpu_torch.inference.server import ContinuousBatcher

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = _moe_model(fields, torch.bfloat16, dev).cast_compute_weights_()
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    gc.collect()
    torch.cuda.empty_cache()
    print(f"moe bf16: Qwen1.5-MoE-A2.7B at its published widths and depth "
          f"({model.depth} layers, no cut), {n_params:,} parameters built on "
          f"the card from seed 0 in {build_s:.2f} s (fp32, then cast: "
          f"{held / 1e9:.2f} GB held, the norms, routers, shared-expert gates "
          f"fp32), peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} "
          f"GiB while building")
    srv = ContinuousBatcher(model, batch_size=8, max_len=1024, scan_depth=4,
                            device=dev)
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 961, 16)
    prompts = [rng.integers(0, model.vocab_size, int(p)) for p in plens]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts(fa)
    t0 = time.perf_counter()
    rids = [srv.submit(p, MOE_NEW) for p in prompts]
    done = dict(srv.run())
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = fa.flash_forward.launches
    at_128 = fa.flash_forward.by_head_dim[128]
    stats = srv.stats()
    ttft = srv.ttft_ms()
    n_tok = sum(len(t) for t in done.values())
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"moe bf16: batch 8, max_len 1024, scan depth 4: {len(done)}/16 "
          f"requests, {n_tok} tokens in {dt:.3f} s ({n_tok / dt:.1f} tok/s), "
          f"mean TTFT {sum(ttft.values()) / max(len(ttft), 1):.1f} ms, "
          f"{dt * 1e3 / n_tok:.2f} ms per output token, prefill "
          f"{stats['prefill_s']:.3f} s in {stats['prefill_waves']} waves, "
          f"decode {stats['decode_s']:.3f} s in {stats['rounds']} rounds "
          f"({stats['decode_s'] * 1e3 / max(stats['rounds'], 1):.2f} ms a "
          f"round of up to 4 ticks), peak {peak:.2f} GiB; prompt lengths "
          f"{[int(p) for p in plens]}; on {_card()}")
    print(f"moe bf16: flash_fwd launches {launches} (at head dim 128: "
          f"{at_128}) over {stats['prefill_waves']} prefill waves x "
          f"{model.depth} layers")
    if sorted(done) != sorted(rids) or any(
            len(t) != MOE_NEW or t.min() < 0 or t.max() >= model.vocab_size
            for t in done.values()):
        raise AssertionError("moe bf16: not every request finished with "
                             f"{MOE_NEW} tokens in the vocabulary")
    if not (launches > 0 and launches == at_128
            and launches == model.depth * stats["prefill_waves"]):
        raise AssertionError("moe bf16: the flash forward did not run once "
                             "a layer a prefill wave at head dim 128")
    _moe_tick_share(model, dev)
    _moe_layout_waves(model, dev, prompts)
    del srv, model
    gc.collect()
    torch.cuda.empty_cache()


def _moe_wave_check(model, dev, label):
    """One prefill wave of 4 prompts of 16-960 tokens (the first four of
    (c)'s), first-token logits flash vs the reference einsum, held as
    `_hf_full` holds them: in fp32 (a twin of `model` on its weights)
    within HF_WAVE_TOL, and in bf16 each path against the fp32 einsum,
    flash within HF_BF16_RATIO times the einsum's own error."""
    import gc

    from tfde_tpu_torch.models.gpt import GPT

    rng = np.random.default_rng(0)
    plens = rng.integers(16, 961, 16)[:4]
    wave = [rng.integers(0, model.vocab_size, int(p)) for p in plens]
    bf16 = _hf_wave_logits(model, wave, dev)
    model32 = GPT(**model.config, dtype=torch.float32, device=dev)
    model32.load_state_dict(model.state_dict())
    fp32 = _hf_wave_logits(model32, wave, dev)
    del model32
    gc.collect()
    torch.cuda.empty_cache()
    rel32 = _rel(fp32["flash"], fp32["reference"])
    err = {impl: _rel(bf16[impl], fp32["reference"]) for impl in bf16}
    finite = all(bool(torch.isfinite(t).all())
                 for t in (*bf16.values(), *fp32.values()))
    print(f"{label}: first-token logits of a wave of prompts "
          f"{[int(p) for p in plens]}, flash vs the reference einsum: fp32 "
          f"rel {rel32:.3e} (tol {HF_WAVE_TOL:g}); each bf16 path against "
          f"the fp32 einsum: flash {err['flash']:.3e}, einsum "
          f"{err['reference']:.3e} (flash held to {HF_BF16_RATIO:g}x the "
          f"einsum's); finite {finite}")
    if not (finite and rel32 <= HF_WAVE_TOL
            and err["flash"] <= HF_BF16_RATIO * err["reference"]):
        raise AssertionError(f"{label}: flash and reference prefill logits "
                             f"disagree")


def _moe_mixtral(fa, dev, fields, root):
    """(d) A Mixtral-8x7B-v0.1 model at full width, depth cut: one wave's
    logits flash vs reference (`_moe_wave_check`), then its artifact
    written by `save_converted` and served by `serve_gpt.main(["--hf-dir",
    ...])` (bf16), the counters zeroed just before: the D-128 forward
    twice a prefill wave (GQA 32 -> 8)."""
    import gc

    from tfde_tpu_torch import serve_gpt
    from tfde_tpu_torch.models.convert import save_converted

    out = os.path.join(root, "mixtral")
    model = _moe_model(fields, torch.bfloat16, dev, MOE_MIXTRAL_DEPTH)
    n_params = sum(p.numel() for p in model.parameters())
    _moe_wave_check(model, dev, f"moe mixtral (depth {MOE_MIXTRAL_DEPTH})")
    t0 = time.perf_counter()
    save_converted(model, out, "mixtral")
    write_s = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    nbytes = os.path.getsize(os.path.join(out, "params.npz"))
    batchers = []
    real = serve_gpt.ContinuousBatcher

    def recording(*args, **kwargs):
        batchers.append(real(*args, **kwargs))
        return batchers[-1]

    serve_gpt.ContinuousBatcher = recording
    try:
        torch.cuda.synchronize(dev)
        _zero_counts(fa)
        t0 = time.perf_counter()
        done = serve_gpt.main(["--hf-dir", out, "--requests", "16",
                               "--batch-size", "8", "--max-len", "1024",
                               "--max-new-tokens", str(MOE_MIXTRAL_NEW)])
        torch.cuda.synchronize(dev)
        entry_s = time.perf_counter() - t0
    finally:
        serve_gpt.ContinuousBatcher = real
    launches = fa.flash_forward.launches
    at_128 = fa.flash_forward.by_head_dim[128]
    waves = batchers[0].stats()["prefill_waves"]
    print(f"moe mixtral: Mixtral-8x7B-v0.1 at its published widths, depth "
          f"{MOE_MIXTRAL_DEPTH} of 32 (cut: 46.7 B parameters are 93 GB in "
          f"bf16), {n_params:,} parameters from seed 0; save_converted wrote "
          f"{nbytes / 1e9:.3f} GB in {write_s:.2f} s; serve_gpt.main "
          f"--hf-dir (load, cast to bf16, 16 requests of 2-8 prompt tokens x "
          f"{MOE_MIXTRAL_NEW}) {entry_s:.2f} s; flash_fwd launches {launches} "
          f"(at head dim 128: {at_128}) over {waves} prefill waves")
    if len(done) != 16 or any(len(t) != MOE_MIXTRAL_NEW for _, t in done):
        raise AssertionError("moe mixtral: serve_gpt --hf-dir did not answer "
                             f"16 requests of {MOE_MIXTRAL_NEW} tokens")
    if not (launches > 0 and launches == at_128
            and launches == MOE_MIXTRAL_DEPTH * waves):
        raise AssertionError("moe mixtral: the D-128 flash forward did not "
                             "run once a layer a prefill wave")
    del batchers
    gc.collect()
    torch.cuda.empty_cache()


def _moe_train_parity(fa, dev):
    """(e) A small MoE GPT (fp32, head dim 64, 4 experts in block 1,
    capacity 1.25, the z-loss on) takes one next_token_loss + AdamW step
    on the card (flash kernels) and on the CPU: loss, ``moe_aux``,
    ``moe_z``, every gradient (router and experts too), the updated
    parameters."""
    from tfde_tpu_torch.models.gpt import GPT, next_token_loss
    from tfde_tpu_torch.training.optimizers import adamw
    from tfde_tpu_torch.training.step import init_state

    cfg = dict(vocab_size=97, hidden_size=256, depth=2, num_heads=4,
               mlp_dim=512, max_position=64, dtype=torch.float32,
               num_experts=4, router_z_loss_weight=1e-3, seed=3)
    models = {"cuda": GPT(device=dev, **cfg), "cpu": GPT(device="cpu", **cfg)}
    models["cpu"].load_state_dict(
        {k: t.cpu() for k, t in models["cuda"].state_dict().items()})
    ids = np.random.default_rng(5).integers(0, 97, (4, 40))
    torch.cuda.synchronize(dev)
    _zero_counts(fa)
    got = {}
    for where, model in models.items():
        state = init_state(model, adamw(model, 1e-3, weight_decay=0.1))
        loss, metrics = next_token_loss(model, torch.as_tensor(
            ids, device=model.device))
        loss.backward()
        grads = {n: p.grad.cpu().clone() for n, p in
                 model.named_parameters()}
        state.apply_gradients()
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        got[where] = (float(loss.detach()),
                      {k: float(metrics[k].detach())
                       for k in ("moe_aux", "moe_z")}, grads, params)
    launched = _counts(fa)
    (l_gpu, m_gpu, g_gpu, p_gpu), (l_cpu, m_cpu, g_cpu, p_cpu) = \
        got["cuda"], got["cpu"]
    loss_rel = max([abs(l_gpu - l_cpu) / abs(l_cpu)]
                   + [abs(m_gpu[k] - v) / abs(v) for k, v in m_cpu.items()])
    grad_rel = _grads_rel(g_gpu, g_cpu)
    param_rel = _rel(torch.cat([p_gpu[n].flatten() for n in p_cpu]),
                     torch.cat([p.flatten() for p in p_cpu.values()]))
    print(f"moe train parity: fp32 MoE GPT (D=64, 4 experts in block 1, "
          f"capacity 1.25, z-loss 1e-3), one next_token_loss + AdamW step, "
          f"CUDA kernels vs CPU plain: loss {l_gpu:.6f} vs {l_cpu:.6f}, "
          f"moe_aux/moe_z {m_gpu} vs {m_cpu} (worst rel {loss_rel:.3e}, tol "
          f"1e-5), worst gradient rel {grad_rel:.3e} (tol 1e-4), updated "
          f"params rel {param_rel:.3e} (tol 1e-4); launches fwd/dkv/dq "
          f"{launched}")
    if launched != (2, 2, 2):
        raise AssertionError("moe train parity: the step did not run each "
                             "flash kernel once a layer")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and param_rel <= 1e-4):
        raise AssertionError("moe train parity: the card disagrees with the "
                             "CPU")


def _moe_gpt_lm(fa, dev):
    """(e) `gpt_lm.main --moe 8` at GPT-2 small width (six MoE blocks of 8
    gelu + bias experts, capacity 1.25), batch 8 x 1024, MOE_GL_STEPS
    steps, in bf16 compute and again in fp32 on the same data and initial
    weights: each flash kernel 12 times a step in both, every loss and
    ``moe_aux`` finite, the cross-entropy (the loss less ``moe_aux``)
    falling in both and the two runs' cross-entropies within
    MOE_GL_CE_TOL step by step; then the layer's two layouts timed and
    GL_PROFILED bf16 steps profiled."""
    import functools
    import gc

    from tfde_tpu_torch import gpt_lm
    from tfde_tpu_torch.data.datasets import synthetic_tokens

    argv = ["--moe", "8", "--max-steps", str(MOE_GL_STEPS), *GL_ARGS]
    runs = {}
    real = gpt_lm.GPT2Small
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        history = []
        gpt_lm.GPT2Small = functools.partial(real, dtype=dtype)
        try:
            state, ms, launches, step_fn = _gl_entry(
                fa, dev, argv, f"moe gpt_lm {name}", history=history,
                minus=("moe_aux",))
        finally:
            gpt_lm.GPT2Small = real
        runs[name] = [h["loss"] - h["moe_aux"] for h in history]
        experts = [b.moe.num_experts for b in state.model.decoder.blocks()
                   if b.moe is not None]
        aux = [h["moe_aux"] for h in history]
        print(f"moe gpt_lm {name}: MoE blocks {len(experts)} of "
              f"{state.model.depth} ({experts[0]} experts each); moe_aux a "
              f"step {[round(a, 5) for a in aux]}; objective (the loss) a "
              f"step {[round(h['loss'], 4) for h in history]}; {ms:.3f} ms "
              f"a step beside the train phase's dense GPT-2 small at the "
              f"same batch (its line above)")
        want = (12 * MOE_GL_STEPS,) * 3
        if launches != want or experts != [8] * 6:
            raise AssertionError(f"moe gpt_lm {name}: launches {launches}, "
                                 f"not {want}, or MoE blocks {experts}")
        if not all(math.isfinite(a) and a > 0 for a in aux):
            raise AssertionError(f"moe gpt_lm {name}: moe_aux not finite: "
                                 f"{aux}")
        if name == "fp32":
            del state, step_fn
            gc.collect()
            torch.cuda.empty_cache()
    gap = max(abs(a - b) for a, b in zip(runs["bf16"], runs["fp32"]))
    print(f"moe gpt_lm: cross-entropy a step, bf16 vs fp32: largest "
          f"difference {gap:.4f} (tol {MOE_GL_CE_TOL:g})")
    if not gap <= MOE_GL_CE_TOL:
        raise AssertionError("moe gpt_lm: the bf16 run's cross-entropy "
                             "leaves the fp32 run's")
    _moe_train_layouts(dev)
    tokens = synthetic_tokens(256, 1024, vocab=state.model.vocab_size,
                              seed=2)
    nrng = np.random.default_rng(1)
    batches = [torch.as_tensor(tokens[nrng.integers(0, 256, 8)], device=dev)
               for _ in range(GL_PROFILED)]
    _profile_train(lambda x: step_fn(state, (x,))[1]["loss"], batches, dev,
                   ms, label="moe gpt_lm")
    del state, step_fn


def phase_moe(fa, dev):
    """Mixture-of-Experts on the card (docstring, phase 20). Every artifact
    lies under build/ and is removed at the end."""
    import shutil

    from tfde_tpu_torch.testing import FULL_WIDTH

    print(f"moe on {_card()}")
    _moe_layer(dev)
    qwen = FULL_WIDTH["Qwen1.5-MoE-A2.7B"][1]
    _moe_fp32(fa, dev, qwen)
    _moe_bf16(fa, dev, qwen)
    _hf_prefill_kernels(fa, dev, MOE_PREFILL)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"moe_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    try:
        _moe_mixtral(fa, dev, FULL_WIDTH["Mixtral-8x7B-v0.1"][1], root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _moe_train_parity(fa, dev)
    _moe_gpt_lm(fa, dev)


PHASES = ("kernels", "parity", "train_parity", "serve", "train", "dp",
          "lifecycle", "export", "resnet",
          "bert", "vit", "gpt_lm", "hf_serve", "prefix_paged",
          "admission", "decoding", "router", "moe")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %(default)s to run after "
                         "the device and build phases (an A/B of kernel and "
                         "train times); the kernels JSON line and the last "
                         "line print only when all run")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tfde_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    phase_device()
    phase_build(fa)

    def run(name, fn, *args):
        """Phase `name` if it was asked for, with its seconds printed."""
        if name not in phases:
            return None
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"{name} phase: {time.perf_counter() - t0:.1f} s")
        return out

    timing = run("kernels", phase_kernels, fa, dev)
    run("parity", phase_parity, dev)
    d256_train = run("train_parity", phase_train_parity, fa, dev)
    run("serve", phase_serve, fa, dev)
    launches = run("train", phase_train, fa, dev)
    dp_ms = run("dp", phase_dp, dev)
    run("lifecycle", phase_lifecycle, fa, dev, dp_ms)
    run("export", phase_export, fa, dev, dp_ms)
    run("resnet", phase_resnet, fa, dev)
    run("bert", phase_bert, fa, dev)
    run("vit", phase_vit, fa, dev)
    _entry_flush()
    run("gpt_lm", phase_gpt_lm, fa, dev)
    d256_serve = run("hf_serve", phase_hf_serve, fa, dev)
    run("prefix_paged", phase_prefix_paged, fa, dev)
    run("admission", phase_admission, fa, dev)
    run("decoding", phase_decoding, fa, dev)
    run("router", phase_router, fa, dev)
    run("moe", phase_moe, fa, dev)
    if len(phases) < len(PHASES):
        print(f"total {time.perf_counter() - t_start:.1f} s (phases "
              f"{','.join(phases)}; no result line)")
        return 1
    # the D-256 kernels' main paths: Gemma-2-2B served (the forward) and
    # the D-256 training check (the backward pair)
    launches.update({"flash_fwd_d256": d256_serve,
                     "flash_bwd_dkv_d256": d256_train["dkv"],
                     "flash_bwd_dq_d256": d256_train["dq"]})
    replaces = {"flash_fwd": ("flash_fwd.cu", 188),
                "flash_bwd_dkv": ("flash_bwd.cu", 606),
                "flash_bwd_dq": ("flash_bwd.cu", 683)}
    kernels = []
    for name in timing:
        source, line = replaces[name.removesuffix("_d256")]
        t = timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"tfde_tpu_torch/csrc/{source}",
            "replaces": f"tfde_tpu/ops/flash_attention.py:{line}",
            "launches": launches[name],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
