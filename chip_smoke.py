#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FlashR on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each printing one JSON line:

1. build   — compile every kernel of ``src/repro_torch/kernels/csrc`` with
             nvcc (all sources at once) and report the seconds.
2. kernel  — each dense kernel at the main paths' full shapes (X =
             65,608,366 × 32 float32, the paper's Friendster-32 input,
             generated on the card from a seeded ``torch.Generator``; xty at
             NMF's and GMM's shapes, its rows naming the thin body's width,
             splits, registers and spills; gram's and wgram's rows naming
             the body that ran (the triangle body, checked against the
             plan), its chunk rows, stages, splits, threads and shared
             bytes, registers and spills; fused_apply_agg's and
             kmeans_assign's rows the same for their ring and TMA bodies;
             gram's, fused_apply_agg's and kmeans_assign's rows also
             ``deterministic``, two calls equal bit for bit, checked), held
             against its plain PyTorch version
             on the same inputs — the float32 one, and for the sums a
             float64 one, entry by entry — and timed with CUDA events beside
             its plain version, its roofline bound and, where one PyTorch
             call computes the same function, that call.  Each kernel's line
             is printed before its checks are applied.
3. small   — summary, correlation, SVD, PCA and naive Bayes on a 4096-row
             slice against numpy.
4. main    — paths a–s: a–c and e–i through ``repro_torch.core.fm``, d
             and j–s through the LM stack, each with the
             kernel launch counters set to 0 just before it and read just
             after (every kernel of the path must have launched):
             a. ``summary``, ``correlation``, ``glm(family="logistic",
                max_iter=8)`` and ``kmeans(k=10, max_iter=5)`` with backend
                ``cuda`` (once to warm, then counted; every materialize is
                one pass; gram must have run its triangle body), then with
                backend ``torch``, compared;
                then ``fm.explain(..., backend="cuda")`` of every
                materialize the four calls make (``"phase": "explain"``
                lines with their dispatch lines): the kernels each call's
                texts name must be those it launched;
             b. ``svd_tall(k=10, compute_u=True)``, ``pca(k=10)``,
                ``nmf(|X|, k=8, max_iter=3)``, ``gmm(k=10, max_iter=3)`` on
                the 10 blobs and ``naive_bayes`` + ``nb_predict`` on the
                blobs' labels, on ``cuda`` (every materialize one pass but
                pca's two; GMM's peak memory printed), then on ``torch``,
                compared;
             e. after path b, the stream and ooc modes: first one 1 GiB
                host→device copy from pageable and one from pinned memory,
                timed (``h2d``);
                then X, y and the blobs copied to host RAM
                (``fm.conv_R2FM(host=True)``) and path a's four calls run
                ``ooc`` from there, partitions staged synchronously
                (``prefetch=False``), and ``crossprod(X)`` with XᵀY and
                ``summary`` in ``stream`` mode over the device-resident X,
                on ``cuda``, traced and counted (gram, xty, wgram,
                fused_apply_agg and kmeans_assign must launch); each call
                prints its wall ms, partition rows, passes, partition
                steps, bytes read from the host, each kernel's launches
                and each pass's ms beside its read floors (its staged
                bytes over the pageable and the pinned rate), and must run
                a pass per materialize, as whole mode, of ⌈n / partition
                rows⌉ > 1 steps; results against path a's (the crossprods
                against whole mode's); then the four ``ooc`` calls again
                through the background prefetcher (the default, depth 2),
                counted on their own: each equal to the synchronous run bit
                for bit (the fields that differ are printed) with the same
                launches, passes, steps and bytes read, and each call's
                line adds a pass's fill of the pinned slots, side-stream
                copy (device time), wait on the staging queue and steps;
                then, outside the counted paths, the prefetcher under
                stress: 2^20 random rows in 512-row partitions, every
                step delayed on the compute stream, at depth 1 and 8 equal
                to the synchronous run bit for bit, and an injected
                staging fault raising ``PrefetchError`` with an empty leak
                audit;
             f. (dense half, inside path e while its host copies and
                prefetched results exist) the disk tier: the registry
                pointed at ``.fm_data/`` under the checkout (git-ignored;
                fails unless ~18 GB are free there), X and y written as
                ``.fmat`` files with ``fm.save_dense_matrix`` and reopened
                with ``fm.get_dense_matrix``; a ``disk`` line (mount and
                file-system type from /proc/mounts, free bytes, the write
                rate of X's file, cold — after fsync and
                ``posix_fadvise(DONTNEED)`` — and warm rates of a 1 GiB
                sequential read, through the memory map and through
                ``readinto``); summary, correlation and glm ``ooc`` from
                disk through the prefetcher warm, summary and correlation
                cold (``direct_io``) and, for correlation, cold with
                ``prefetch=False``, each line
                as path e's plus ``disk_read_floor_ms`` (a pass's staged
                bytes over the faster cold rate) and each result equal to
                path e's prefetched host-tier result bit for bit with the
                same launches, passes, steps and bytes read (a
                ``"compare", "path": "disk"`` line names any field that
                differs); then ``scale(X, save="disk")``: two passes, the
                second written through to an 8.4 GB spill file whose size
                and header are checked, a summary of it from disk (means
                within 1e-5 of 0, sds of 1) and 4096 random rows against
                float64; counted; then path g, ``fm.batch``, while X and y
                live on the device, in host RAM and on disk:
                ``colMeans(X)``, ``(colSds(X), crossprod(X))``, ``sum_(X)``
                and ``crossprod(X, y)`` (the first three ride the fourth's
                {X, y} stream) on device ``whole``, device ``stream``, host
                ``ooc`` and disk ``ooc`` (warm), each tier as four solo
                materializes and as one batch, each once warm and then
                measured untraced: wall ms, streams, passes, steps, pass
                bytes, bytes read, launches and the staging seconds a
                stream, the group's partition rows beside each member's;
                checked: one stream against four, four passes, the union
                of X and y read once, gram, xty and fused_apply_agg once a
                partition of the group, and each result bit for bit with
                its serial run where the member's own partition rows are
                the group's, else with its request run alone at the
                group's rows (the relative difference from the serial run
                is printed); three batches under ``fm.inspect_iterations()``
                (4 reuse hits: X and y in each batch after the first); and
                ``fm.explain_batch`` of the requests (``members=4``, the
                union's bytes against the serial sum); counted; then path
                h, ``fm.serve``, over the same host and disk copies (and
                the blobs' host copy), counted, each arm once warm and
                then measured (wall ms until every result is read back and
                the card is idle): h1, path g's four requests from four
                tenant threads (a barrier, a ``fm.collect_stats()`` scope
                each) into one Engine window (``max_window_requests=4``,
                no mid-stream admission), ``ooc`` from host RAM and from
                disk — one stream, four passes, X and y read once, each
                tenant's scope its own plan's bytes and one stream, gram
                and xty once a partition and fused_apply_agg twice, every
                result equal to path g's batch on that tier bit for bit,
                the wall ms beside path g's batched and serial ms; h2,
                ``colSums(X)`` ``ooc`` from the host copy through a paced
                store that holds the sweep at its second partition until a
                late ``colMeans(X)`` is parked in the live gate, with the
                prefetcher on and off, traced — one admit, one stream, two
                passes, the catch-up's bytes the prefix the late member
                missed (its ``catch_up`` span), both results within
                ``F64_TOL`` of float64 in units of Σ|x| and the late one's
                relative difference from its solo run printed; h3,
                colMeans and crossprod over X and over the blobs in one
                window — two groups — with ``max_concurrent_streams`` 2
                and 1: two streams, the launches those of the two groups'
                ``fm.batch`` runs summed, every result bit for bit with its
                request run alone at the group's rows, the pinned host
                bytes of the prefetchers' rings at their peak; h4, h3's
                traffic under ``max_inflight_bytes`` = one group's bytes: a
                deferral at least, h3's results bit for bit, the admission
                wait printed; h5, ``repro_torch.launch.serve.main`` in
                process over 2^24 × 32 rows (a cut: it draws its matrix
                with numpy on the host), 4 clients, 3 waves — the serve
                arm's streams equal to the waves, its bytes a request ×
                clients equal to the serial arm's, both ``BENCH`` rows
                printed; then path i's dense half, sharded execution
                over ``[cuda:0] × k`` (``launch.mesh.Mesh``: each shard a
                thread and a CUDA stream of its own), counted, each line
                beside its unsharded twin: i1, ``correlation``,
                ``summary``, ``glm(max_iter=3)``, ``kmeans(k=10,
                max_iter=2)`` and ``crossprod`` in ``stream`` mode over the
                device X unsharded and under k = 1, 2, twice each — k
                shards and k − 1 merges a pass, ``shard_bytes_in`` k
                entries summing to the pass's bytes, the unsharded
                passes, steps and launches, k = 1 bit for bit with
                unsharded, each k bit for bit run to run, the Gram within
                ``F64_TOL`` of float64; i2, ``crossprod`` and ``colSums``
                in ``whole`` mode with ``mesh=`` — two row blocks at k = 2
                (65,608,366 divides by 2), unsplit and bit for bit with
                whole mode at k = 4 (it does not divide by 4); i3, path
                g's four requests as one ``fm.batch(mesh=[cuda:0] × 2)``
                ``ooc`` from host RAM through two prefetchers — one
                stream, two shards, X and y read once, the pinned peak,
                each output beside path g's batch; i4,
                ``scale(D, save="disk")`` under k = 2, D the first 2^24
                rows of X as an ``.fmat`` (a cut of depth), both shards'
                rows in one spill file (size, header, 4096 rows against
                float64); i5, ``Engine(mesh=[cuda:0] × 2)`` with two
                tenants, ``colMeans`` and ``crossprod`` from host RAM —
                sharded, no gate, no mid-stream admit; then i7, a
                staging fault in one shard of two: it raises, nothing
                registers, no prefetcher, staged partition or shard thread
                is left; the files removed in a ``finally``;
             c. after the dense data is freed, the sparse path at the scale
                of the Criteo Display Advertising Challenge train set
                (Kaggle, 2014): 45,840,617 rows × 26 categorical columns,
                each hashed to 64 buckets (ncol = 1,664, a cut: the kernels
                hold a dense ncol × ncol Gram), codes drawn per column from
                a Zipf-like law and y from a logistic model; first the SpMM
                kernel rows (as phase 2), then ``glm(Xs, y, "logistic",
                ridge=1e-3, max_iter=8)`` and one ``crossprod(Xs)`` on
                ``cuda``, checked for convergence and exact level counts,
                then ``crossprod`` and, on the first 2^22 rows,
                ``glm(max_iter=2)`` in ``stream`` mode over the device slab
                (counted: every SpMM kernel per partition; the Gram equal
                to whole mode's bit for bit, the log-likelihoods to a
                whole-mode fit's within 1e-4); then the slab copied to host
                RAM as the host-tier store ``fm.one_hot`` builds
                (``fm.persist(tier="host")``) and the same ``crossprod``
                and 2^22-row ``glm`` run ``ooc`` through the prefetcher
                (counted: ``spmm_gram`` once a partition, the Gram equal to
                whole mode's bit for bit, the log-likelihoods within 1e-4
                of the device slab's ``stream`` fit), then path g's sparse
                half: ``crossprod(Xs)`` and ``crossprod(Xs, y)`` from the
                host slab as two solo materializes and as one batch
                (counted: one stream against two, ``spmm_gram`` and
                ``spmm_xty`` once a partition of the group, the Gram equal
                to whole mode's and XᵀY to the serial run's bit for bit)
                (the ``spmm_gram`` / ``spmm_wgram`` rows also print the
                kernel's design — threads, tile edge, tiles, splits, body,
                registers and spills — and ``pair_products``, the in-tile
                shared-memory atomics of one call, counted on the card from
                each row's per-stripe entry counts; the ``spmm_xty`` row its
                design — warps, stripe, tiles, splits, rows in flight,
                swizzle, registers and spills — and ``deterministic``, two
                calls equal bit for bit, checked);
                then path f's sparse half: the host slab written as a CSR
                ``.fmat`` (``fm.persist(tier="disk")``, its write time
                printed), reopened by name and ``crossprod``-ed ``ooc``
                through the prefetcher warm and cold (counted:
                ``spmm_gram`` once a partition, the Gram equal to whole
                mode's bit for bit, ``pass_bytes_in`` the file's CSR bytes);
                path i's sparse half (i6, before the CSR file, counted)
                under ``[cuda:0] × 2``: ``crossprod`` in ``stream`` over
                the device slab and ``ooc`` from the host slab and
                ``glm(max_iter=2)`` in ``stream`` on the 2^22-row slab,
                beside their unsharded runs — the SpMM launches and steps
                as unsharded, 2 shards a pass, the Gram within
                ``SPARSE_SHARD_TOL`` of whole mode's, the log-likelihoods
                within 1e-4 of the unsharded fit's;
                ``torch``, which densifies, is compared with ``cuda`` on the
                first 2^18 rows;
             d. after the Criteo data is freed, the LM serving path
                (``repro_torch.launch.steps``) at llama3.2-3b's published
                width — 28 layers, d_model 3072, 24 heads over 8 KV heads,
                head dim 128, d_ff 8192, vocab 128,256 — with bf16 parameters
                drawn from seed 2016: first the ``flash_attention`` kernel
                row (B 4, 24 q heads, 8 KV heads, S = T = 4096, bf16, causal,
                held within one bf16 rounding of its f32 plain version and of
                float64 on a few heads, and an f32 case; the row names the
                kernel body that ran, its design bound and its registers and
                spills from the build log, and a head-dim-112 case — zamba2-
                7b's 32 heads, S = 4096, bf16, causal, on the FMA body —
                held to the same rule, its time printed), then 4 prompts of
                4096 random tokens prefilled (the kernel must launch once per
                layer) and 32 greedy decode steps, counted; then the checks,
                at the same shape with the same weights and activations
                widened to float32 (in bf16 both read the rounding noise of
                these random weights, PERF.md; those readings are printed):
                (a) the last-position logits against the same prefill with
                the plain attention (``attn_impl="ref"``); (b) prefill + one
                decode step against a prefill one token longer (the twin of
                tests/test_archs.py); (c) is (a) in float32, which (a) now
                is at the full shape; (d) every logit finite.
             j. after the serving weights are freed, training
                (``repro_torch.launch.steps.build_train_step``), which runs
                no kernel: the JAX package's train forward computes
                attention in jnp, so the port's is plain PyTorch (the
                launch counters are set to 0 before j2 and must read 0
                after it).  j1: ``blockwise_attention`` at the full-width
                layer shape — q (1, 4096, 24, 128), k/v (1, 4096, 8, 128),
                f32, causal, bk 1024 — and its backward against the grouped
                route under autograd, each of out, dq, dk, dv within
                ``TRAIN_TOL`` of its largest entry, forward and
                forward + backward ms, peak memory; j2: llama3.2-3b's train
                step at full width and depth (f32 masters, bf16
                activations, remat, bf16 moments, seq 4096, global batch 2
                in 2 microbatches — a cut of train_4k's 256 — tokens from
                ``DataIterator``, the learning rate under
                ``warmup_cosine``), one warm and ``TRAIN_STEPS`` timed
                steps: ms, tokens/s, loss, grad norm, peak memory, model
                FLOPs (6·N·tokens + 12·L·S²·d_head·n_heads·B) and their
                share of 989 TFLOP/s; finite, the loss of the last step
                below the first's; j3: at full width and a depth of 2 in
                float32, gradients with remat on against off, two
                microbatches against one and the blockwise route against
                the grouped one at S = 4096, each leaf within
                ``TRAIN_TOL``; j4: ``launch.train.main`` over qwen2-0.5b
                at full width and depth (4 steps, a checkpoint every 2,
                then ``--resume`` to step 6, which must run 2 steps) and
                the checkpoint's round trip — restored onto the card and
                saved again, every leaf's CRC-32 equal — with its bytes
                and save and restore seconds; the directory removed.
             k. after path j's state is freed, the MoE family served
                (``steps.serving_model`` → ``build_prefill_step`` →
                ``build_decode_step``): first the ``flash_attention``
                kernel at qwen3-moe-30b-a3b's attention shape — q (4, 32,
                4096, 128), k/v (4, 4, 4096, 128), GQA group 8, bf16,
                causal, the ``wgmma`` body — under the serving row's rule
                (2e-3 + 1e-2·|plain| of the f32 plain version, one bf16
                ulp of float64 on three heads) with its ms, the plain
                version's, SDPA's and the bound; then qwen3-moe-30b-a3b at
                full width and depth (48 layers, 128 experts, top-8;
                61.06 GB of bf16 weights from seed 2016, drawn a layer at
                a time: the init's seconds and its peak over the weights,
                checked <= 2 GiB), 4 prompts of 4096 tokens and 32 greedy
                decode steps, counted (48 launches a prefill), with the
                pairs dropped by capacity at each layer (C = 320 a row);
                then at full width and a depth of ``MOE_CHECK_LAYERS`` in
                float32 (the first layers widened): (a) at the main
                prompt and (b) at the dropless prompt
                ``MOE_DROPLESS_PROMPT``, each within ``LM_F32_TOL``, with
                the tokens whose top-k routes differ between the two runs
                printed; (d) every logit finite.
             l. then the VLM: the kernel at paligemma-3b's shape — q (4,
                8, 4096, 256), k/v (4, 1, 4096, 256), MQA at head dim 256,
                the FMA body — as in path k, then paligemma-3b at full
                width and depth (18 layers, tied embeddings, GeGLU), 4
                prompts of 256 patch embeddings (normal, seed 2016, bf16)
                and 3840 tokens, 32 greedy decode steps, counted (18
                launches a prefill), the kernel's share of prefill; then
                (a), (b) and (d) as path d, in float32 at full depth.
             m. then the SSM: mamba2-1.3b at full width and depth (48
                layers, d_model 2048, 64 SSM heads of 64, state 128, vocab
                50,280, untied; 2.89 GB of bf16 weights from seed 2016), 4
                prompts of 4096 tokens and 32 greedy decode steps,
                counted: no attention, so ``flash_attention`` must launch
                0 times; the SSM cache's bytes printed; then in float32 at
                full depth (b) prefill + one decode step against a prefill
                one token longer (4097: the chunked scan's pad path), (e)
                layer 0's chunked scan (``ssm.apply_ssm``) over the 4 ×
                4096 prompt against the same layer token by token through
                ``apply_ssm_decode`` from a zero cache — its output, final
                state and conv window — each within ``LM_F32_TOL``, and (d)
                every logit finite; (a) does not apply.
             n. then the hybrid: the kernel at zamba2-7b's attention shape
                — q, k, v (4, 32, 4096, 112), MHA at head dim 112, the FMA
                body — as in path k; then zamba2-7b at full width and
                depth (81 layers: 13 groups of 6 SSM layers, each followed
                by the one shared attention + MLP block, and a tail of 3;
                d_model 3584, 32 heads of 112, d_ff 14,336, vocab 32,000;
                13.50 GB of bf16 weights), 4 prompts of 4096 tokens and 32
                decode steps, counted (13 launches a prefill: one an
                application of the shared block), the kernel's share of
                prefill and the 13 KV caches' bytes; then (a), (b) and (d)
                in float32 at full width and depth, the bf16 (a) and (b)
                printed at full depth and at a depth of 15 — the first two
                groups and the tail.
             o. then the enc-dec: the kernel at whisper-medium's three
                attention shapes — the encoder's q, k, v (4, 16, 1500, 64)
                and the cross-attention's q (4, 16, 416, 64) over k, v (4,
                16, 1500, 64), not causal, the decoder's (4, 16, 416, 64),
                causal; each as in path k, SDPA with the same
                ``is_causal`` — then whisper-medium at full width and
                depth (24 encoder + 24 decoder layers, d_model 1024, 16
                heads of 64, d_ff 4096, vocab 51,865; 1.62 GB of bf16
                weights from seed 2016), 4 × 1500 normal bf16 frame
                embeddings (the stub frontend's), 4 prompts of 416 tokens
                and 32 greedy decode steps (448 positions, whisper's text
                context), counted: 72 launches a prefill (an encoder layer
                one, a decoder layer two: self and cross) and none in the
                decode steps; the encoder alone timed once, the self and
                cross K/V caches' bytes (checked against their shapes) and
                the prefill and decode floors printed; then (a), (b) and
                (d) in float32 at full depth, the same frames in every
                batch; then o-train: one warm and 2 timed AdamW steps at
                full width and depth (f32 masters, bf16 activations and
                moments, remat), 2 × 448 tokens and 1500 frames each, a
                finite loss and no kernel launched.
             p. then sharded training (``launch.steps.build_train_step``
                over a ``launch.mesh.Mesh`` of repeated positions of the
                one card, ``distributed.sharding.tree_shardings``): p1,
                llama3.2-3b's train step at full width and depth over
                ``[cuda:0] × 4`` as (data 2, model 2) with path j2's
                settings (f32 masters, bf16 activations and moments,
                remat, seq 4096, global batch 2 — one row a data row, so
                ``grad_accum`` 1 by ``rescale_grad_accum`` — the same
                warm-up schedule), one warm and 2 timed steps: ms,
                tokens/s, peak memory, j2's mean ms beside them; each
                position's stored bytes of every parameter and moment
                equal to its spec's block, a finite loss, no kernel
                launched (the counters set to 0 before p1 and read after
                it); p2, full width, depth 2, float32: one sharded step
                against the unsharded one from the same parameters and
                batch, the loss within 1e-3 relative and every gradient
                leaf within ``TRAIN_TOL`` of its largest entry, and two
                sharded runs bit for bit; p3, p2's state after one sharded
                AdamW step saved, then restored onto ``replan_mesh(2,
                prefer_model=2)`` over ``[cuda:0] × 2``, every leaf bit
                for bit and laid out by the new sharding; p4,
                ``optim.compression.cross_pod_psum_int8`` over a ``pod``
                axis of the card's 4 positions on p2's gradient tree as
                AdamW takes it (clipped to global norm 1; the position k
                copy scaled by (k + 1)/4), 30 rounds, the mean within rtol
                0.05, atol 2e-5 of the exact sum, ms a round.
             q. then serving over a mesh and the dry-run's account: q1,
                llama3.2-3b at full width and depth with path lm's bf16
                weights and prompts (seed 2016) over ``[cuda:0] × 4`` as
                (data 2, model 2) — ``build_prefill_step`` /
                ``build_decode_step`` on ``ShardedTensor`` parameters, one
                thread and CUDA stream a data row, the flash kernel inside
                the rows — one warm prefill, then counted: the prefill of
                4 × 4096 with the parameters laid out by ``prefill_specs``'
                shardings, the parameters re-laid out by ``decode_specs``'
                under ``serve_mode`` (weights resident over ``data``), 4
                greedy decode steps; then each data row's 2 prompts run
                alone, unsharded, through the same greedy tokens: every
                step's logits and the final cache's rows bit for bit
                (checked), 28 flash launches a row in the prefill and none
                in decode, each position holding exactly its blocks of the
                parameters and the cache; prefill ms, decode ms a step and
                each cell's peak over what was resident before its
                arguments beside path lm's, the greedy tokens of row 0
                beside lm's (printed, not checked); q2, the account
                (``steps.lower_cell(..., one_device=True)`` on meta
                tensors, in this process) of p0's, p1's and q1's prefill
                and decode cells: its peak for positions sharing the card
                within ``ACCOUNT_TOL`` of the measured peak, the positions'
                summed ``peak_device_bytes`` and the roofline's terms
                (``launch/roofline.py``) printed beside the measured times.
             r. then the MoE and the enc-dec computing over ``model``: r1,
                qwen3-moe-30b-a3b at full width and depth, bf16, over
                ``[cuda:0] × 2`` as (data 1, model 2) — one copy of the
                weights, laid out a layer at a time (never a whole stacked
                leaf beside its blocks; the init's transient printed),
                each position its 64 experts and 16 heads — the flash
                kernel at a position's shape, then 4 × 4096 prompts
                prefilled once warm and counted with 4 greedy steps: ms
                beside path k's, each position's bytes, the peak, 48 flash
                launches a position in the prefill and none in decode, the
                dropped pairs a layer; r2, qwen3-moe at full width and
                depth 2 in float32 over (data 2, model 2): a capacity-
                bound train step (4 × 640 tokens) against the unsharded one
                within 1e-5, one gradient block a position, bit for bit
                run to run, then a prefill and 4 decode steps against each
                data row served alone within 1e-5, the route flips
                printed; r3, whisper-medium at full width and depth over
                (data 2, model 2): the flash kernel at a position's three
                shapes, bf16 serving of path o's shape (4 × 1500 frames,
                416 tokens, 4 greedy steps; 72 flash launches a position,
                the cross cache split by sequence) beside path o's ms,
                o-train's step over the positions beside o's, then float32
                at full depth: a train step against the unsharded one and
                serving against the rows alone, within 1e-5; r4, the
                account of r1's prefill and decode cells and r3's train
                cell against the card, as q2.
             s. then the SSM and the hybrid computing over ``model``: s1,
                zamba2-7b at full width and depth, bf16, over ``[cuda:0] ×
                2`` as (data 1, model 2) — one copy of the weights laid out
                a layer at a time (a group of six SSM layers and a tail
                layer a draw; the init's transient printed), each position
                its 56 of the 112 SSM heads of every layer and 16 of the
                shared block's 32 attention heads — the flash kernel at a
                position's shape, then 4 × 4096 prompts prefilled once
                warm and counted with 4 greedy steps: ms beside path n's,
                each position's bytes, the peaks, 13 flash launches a
                position in the prefill and none in decode; s2,
                mamba2-1.3b at full width and depth over (data 2, model 2)
                with path m's shape, beside path m's, no flash launch;
                each position holding exactly its blocks of every
                parameter and cache leaf; s3, float32 at full width,
                mamba2 at depth 2 and zamba2 at depth 7 over (2, 2), 4 ×
                520-token prompts (the scan's pad path): a train step
                against the unsharded one (one gradient block a position,
                bit for bit run to run) and a prefill and 4 decode steps
                against each data row served alone, each leaf, step and
                cache within 1e-5 or, where the unsharded step's own
                float32 floor passes that, within ``FLOOR_FACTOR`` × the
                floor (printed beside it); then zamba2's train step with
                AdamW over (2, 2), its peak; s4, the account of s1's
                prefill and decode cells and s3's zamba2 train cell
                against the card, as q2.

Then the run's seconds, one ``{"kernels": [...]}`` line (launches summed
over the counted runs of the paths), the card's name and power
limit as ``nvidia-smi`` prints them, and
last the line ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before the last line.  TF32 is switched off for matmul and cuDNN,
so every plain version and library call computes in full float32.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time

N_ROWS = 65_608_366      # Friendster-32: rows of the paper's dense input
N_COLS = 32
K_CLUSTERS = 10
NMF_K = 8
SEED = 2016
CRITEO_ROWS = 45_840_617  # Criteo Display Advertising Challenge train set
CRITEO_FACTORS = 26       # its categorical columns
CRITEO_BUCKETS = 64       # hash buckets a column (a cut, see the docstring)
ZIPF_S = 1.1              # P(bucket k) ∝ (k + 1)^-s
SPARSE_CMP_ROWS = 1 << 18  # rows on which the densifying torch backend runs
#: Rows of the slab the streamed sparse fit reads: its passes are cut into
#: 4,096-row partitions (a 1,664-wide row-local value sets the width), so
#: the whole slab would be 11,192 steps a pass.
SPARSE_STREAM_ROWS = 1 << 22
DEVICE = "cuda"
HBM_BYTES_S = 3.35e12    # H100 SXM data sheet
F32_FLOP_S = 67e12       # H100 SXM data sheet, f32 outside the tensor cores
BF16_FLOP_S = 989e12     # H100 SXM data sheet, dense bf16 tensor cores
LM_ARCH = "llama3.2-3b"  # the serving path's model, at its published width
LM_BATCH = 4             # prompts a prefill
LM_PROMPT = 4096         # tokens a prompt
LM_DECODE = 32           # greedy decode steps
MOE_ARCH = "qwen3-moe-30b-a3b"  # path k's model, full width and depth
VLM_ARCH = "paligemma-3b"       # path l's model, full width and depth
SSM_ARCH = "mamba2-1.3b"        # path m's model, full width and depth
HYBRID_ARCH = "zamba2-7b"       # path n's model, full width and depth
ENCDEC_ARCH = "whisper-medium"  # path o's model, full width and depth
#: Path o's text prompt: with LM_DECODE decode steps, 448 positions —
#: whisper-medium's published text context (max_target_positions).
ENCDEC_PROMPT = 416
ENCDEC_TRAIN_BATCH = 2   # o-train's sequences a step, each 448 tokens
ENCDEC_TRAIN_STEPS = 2   # o-train's timed steps, after one warm step
#: Path n also prints its bf16 (a) and (b) at full width and this depth
#: (the first two groups of 6 SSM layers and the 3-layer tail) beside the
#: full depth's, so the two show what depth does to bf16 rounding.
HYBRID_SHALLOW_LAYERS = 15
#: Path k's float32 checks run the model's first layers at full width (a
#: cut of depth: all 48 in float32 would be 122 GB).
MOE_CHECK_LAYERS = 2
#: Path k's check (b) prompt: (511 + 1) · top-8 = 4096 pairs a row, the
#: most that routes dropless, so prefill + decode and the longer prefill
#: keep every pair.
MOE_DROPLESS_PROMPT = 511
#: Limit of the serving checks (a) and (b), in float32: max |diff| over
#: max |logit|.  The JAX package's bf16 limit (tests/test_archs.py) is 2e-2.
LM_F32_TOL = 1e-3
TRAIN_ARCH = "llama3.2-3b"  # path j's model, at its published width and depth
TRAIN_SEQ = 4096         # train_4k's sequence length
TRAIN_BATCH = 2          # global batch a step (train_4k: 256; a cut)
TRAIN_ACCUM = 2          # microbatches a step
TRAIN_STEPS = 3          # timed steps, after one warm step
TRAIN_BK = 1024          # blockwise attention's KV chunk
#: j2's learning rate: AdamConfig's 3e-4 peak under ``warmup_cosine``'s
#: default warmup (200 steps), so the timed steps run at 1.5e-6 .. 4.5e-6.
#: A constant 3e-4 from the first step raised the loss from 12.69 to 16.45
#: in three steps at this width (PERF.md).
TRAIN_WARMUP = 200
TRAIN_CHECK_LAYERS = 2   # j3's depth at full width (a cut of depth)
#: Limit of j1 and j3, each tensor's max |diff| over its largest |entry|,
#: float32 on both sides (the tests' CPU limit for gradients).
TRAIN_TOL = 1e-4
TRAIN_MAIN_ARCH = "qwen2-0.5b"  # j4's launcher run, full width and depth
SHARD_MESH = (2, 2)      # path p's (data, model) positions on the one card
SHARD_STEPS = 2          # p0's and p1's timed steps, after one warm step
SHARD_CHECK_LAYERS = 2   # p2's depth at full width (a cut of depth)
SERVE_MESH = (2, 2)      # path q's (data, model) positions on the one card
SERVE_F32_LAYERS = 2     # q1's float32 arm's depth at full width (a cut)
SERVE_F32_STEPS = 4      # q1's float32 arm's greedy decode steps
SERVE_DECODE = 4         # q1's greedy decode steps (a cut of path lm's 32)
TP_TOL = 1e-5            # p2, q1 float32: against one device, of the largest
ACCOUNT_TOL = 0.10       # q2: the account's peak bytes against the card's
MOE_TP_MESH = (1, 2)     # r1's (data, model) positions: one copy of the weights
MOE_TP_DECODE = 4        # r1's and r2's greedy decode steps
MOE_TP_CHECK_LAYERS = 2  # r2's depth at full width (a cut of depth)
MOE_TP_TRAIN_SEQ = 640   # r2's tokens a row: 640 · 8 pairs > 4096 (capacity)
ENCDEC_TP_MESH = (2, 2)  # r3's (data, model) positions
ENCDEC_TP_DECODE = 4     # r3's greedy decode steps
HYBRID_TP_MESH = (1, 2)  # s1's (data, model) positions: one weight copy
SSM_TP_MESH = (2, 2)     # s2's and s3's (data, model) positions
SSM_TP_DECODE = 4        # s1's, s2's and s3's greedy decode steps
SSM_TP_PROMPT = 520      # s3's tokens: four chunks of 128 and 8 (the pad path)
#: s3's depths at full width (cuts): zamba2's one group of six SSM layers,
#: the shared block and a tail of one
SSM_TP_CHECK_LAYERS = {"mamba2-1.3b": 2, "zamba2-7b": 7}
#: s3's bounds: a leaf, step or cache whose float32 floor — the unsharded
#: step's distance from itself computed in another order — passes
#: ``TP_TOL`` is held within this many times its floor instead
FLOOR_FACTOR = 2.0
#: Path p2's limit on the sharded loss against the unsharded one, relative
#: (the JAX package's test_multidevice_equivalence bound).
SHARD_LOSS_TOL = 1e-3     # p0, p1 (bf16) against j2's loss
SHARD_INT8_ROUNDS = 30   # p4's rounds (the JAX package's test)
CHUNK_ROWS = 1 << 22     # rows per chunk of a float64 plain version
#: Limits on a float32 kernel's error against its float64 plain version,
#: per entry, in units of that entry's condition: sqrt(G_ii·G_jj) for a Gram
#: entry (the units of a correlation), the sum of |terms| for a cluster sum,
#: the value itself for wss (a sum of positive terms).  A Gram diagonal adds
#: n positive terms and rounds in proportion to its size; an off-diagonal
#: entry of independent columns adds terms of both signs and rounds far
#: less, so it gets its own, tighter limit.  Both are set from the kernels'
#: measured error on this input (PERF.md): Gram diagonals 3.1e-6 and
#: 3.8e-6, off-diagonals 1.5e-9 and 1.7e-9, cluster sums 1.1e-6.
F64_TOL = 1e-5
F64_TOL_OFFDIAG = 2e-8
#: Limit on a mid-stream member's result against its solo run (path h2), in
#: units of the output's largest entry: it folds the sweep's tail before
#: the prefix it missed, so its float32 partials add in another order.
#: Path g measured 7.2e-7 for colMeans at another partition order (PERF.md).
SOLO_NORM_TOL = 1e-5

REPO = pathlib.Path(__file__).resolve().parent
#: Where path f writes its ``.fmat`` files: under the checkout (git-ignored),
#: on the checkout's own file system; emptied when the path is done.
DISK_DIR = REPO / ".fm_data"
#: Rows of the matrix path h's load generator draws with numpy on the host
#: (a cut: all 65.6M rows would take 20-40 s to draw), at Friendster-32's
#: width.
LOADGEN_ROWS = 1 << 24
#: Bytes path f's dense half holds on disk at its peak: X and its spill
#: (8.4 GB each), y and path h's load-generator matrix (2.1 GB), with 1 GiB
#: to spare; the CSR half (9.9 GB) comes after they are removed.
DISK_NEED = (2 * N_ROWS * N_COLS * 4 + N_ROWS * 4
             + LOADGEN_ROWS * N_COLS * 4 + (1 << 30))
#: Rows of the ``.fmat`` path i4 spills through two shards (a cut of
#: depth: the full spill is path f's, 14-18 s).
SPILL_ROWS = 1 << 24
#: Rows of the host store path i7 injects its shard fault into.
FAULT_ROWS = 1 << 22
#: Limit on a sharded sparse Gram against whole mode's, relative to its
#: largest entry: every entry is an integer count under 2^24, which float32
#: adds exactly in any order, so the measured difference should be 0.
SPARSE_SHARD_TOL = 1e-6
#: Rows of X in the 1 GiB the disk line reads cold and warm.
DISK_RATE_ROWS = (1 << 30) // (N_COLS * 4)
#: The cold read rate (bytes/s) path f's dense half measured: the disk
#: read floor of every disk pass, the CSR half's too.
DISK_COLD_RATE = {}

#: Each kernel's launch counter: (module of repro_torch.kernels, attribute).
COUNTERS = {
    "gram": ("gram", "launches"),
    "xty": ("gram", "xty_launches"),
    "fused_apply_agg": ("fused_apply_agg", "launches"),
    "wgram": ("weighted_gram", "launches"),
    "kmeans_assign": ("kmeans_assign", "launches"),
    "spmm_gram": ("spmm", "gram_launches"),
    "spmm_xty": ("spmm", "xty_launches"),
    "spmm_wgram": ("spmm", "wgram_launches"),
    "flash_attention": ("flash_attention", "launches"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def _counter(name):
    import importlib
    mod, attr = COUNTERS[name]
    return importlib.import_module(f"repro_torch.kernels.{mod}"), attr


def zero_counts():
    for name in COUNTERS:
        mod, attr = _counter(name)
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(*_counter(name)) for name in COUNTERS}


def counted(torch, path, kernels, run):
    """Drive one main path with every launch counter set to 0 just before
    and read just after; each of ``kernels`` must have launched."""
    torch.cuda.synchronize()
    zero_counts()
    out = run()
    torch.cuda.synchronize()
    got = read_counts()
    check(all(got[k] > 0 for k in kernels),
          f"a kernel of the {path} path never launched: "
          f"{ {k: got[k] for k in kernels} }")
    return out, got


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes, ops, flop_s=F32_FLOP_S):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(torch, a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def row_chunks(n):
    return ((s, min(n, s + CHUNK_ROWS)) for s in range(0, n, CHUNK_ROWS))


def gram64(torch, x, w=None):
    """XᵀX, or XᵀWX with per-row weights w, in float64, a chunk of rows at
    a time."""
    p = x.shape[1]
    g = torch.zeros((p, p), dtype=torch.float64, device=x.device)
    for s, e in row_chunks(x.shape[0]):
        xc = x[s:e].double()
        g += (xc if w is None else xc * w[s:e].double()[:, None]).T @ xc
    return g


def corr_err(torch, g, g64):
    """|G − G64|_ij / sqrt(G64_ii · G64_jj), the error in the units of a
    correlation: its max over the diagonal and over the other entries."""
    d = g64.diagonal().clamp_min(1e-300).sqrt()
    e = (g.double() - g64).abs() / torch.outer(d, d)
    off = ~torch.eye(e.shape[0], dtype=torch.bool, device=e.device)
    return float(e.diagonal().max()), float(e[off].max()) if off.any() else 0.0


def lloyd64(torch, x, c, lab):
    """Cluster sums, their condition (sums of |x|), counts and wss of a
    Lloyd step with the given labels, in float64."""
    k, p = c.shape
    c64 = c.double()
    sums = torch.zeros((k, p), dtype=torch.float64, device=x.device)
    abs_sums = torch.zeros_like(sums)
    wss = torch.zeros((), dtype=torch.float64, device=x.device)
    for s, e in row_chunks(x.shape[0]):
        xc = x[s:e].double()
        lc = lab[s:e].long()
        onehot = torch.nn.functional.one_hot(lc, k).double()
        sums += onehot.T @ xc
        abs_sums += onehot.T @ xc.abs()
        wss += ((xc - c64[lc]) ** 2).sum()
    counts = torch.bincount(lab.long(), minlength=k).double()
    return sums, abs_sums, counts, wss


def make_data(torch):
    """X ~ N(0, 1); y from a logistic model with a fixed β; Xk: 10 blobs
    and their labels."""
    import numpy as np
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = torch.randn((N_ROWS, N_COLS), generator=gen, device=dev)
    beta = torch.as_tensor(
        np.random.default_rng(SEED).uniform(-0.5, 0.5, N_COLS),
        dtype=torch.float32, device=dev)
    prob = torch.sigmoid(x @ beta)
    y = (torch.rand(N_ROWS, generator=gen, device=dev) < prob).float()
    del prob
    centers = torch.randn((K_CLUSTERS, N_COLS), generator=gen,
                          device=dev) * 4.0
    lab = torch.randint(0, K_CLUSTERS, (N_ROWS,), generator=gen, device=dev)
    xk = torch.randn((N_ROWS, N_COLS), generator=gen, device=dev)
    xk += centers[lab]
    torch.cuda.synchronize()
    return x, y, xk, lab.to(torch.int32)


def kernel_phase(torch, x, xk):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core import fm
    from repro_torch.algorithms.kmeans import _init_centers
    from repro_torch.core.fusion import Plan
    from repro_torch.kernels import (build, fused_apply_agg as faa,
                                     gram as gram_mod, kmeans_assign as ka,
                                     ref, weighted_gram as wg)
    n, p = x.shape
    rows = []

    # gram: correlation's crossprod(X).
    tri_before = gram_mod.tri_launches
    g = gram_mod.gram(x)
    plan = gram_mod.tri_plan(n, p, x.dtype, weighted=False)
    body = "tri" if gram_mod.tri_launches > tri_before else "tile"
    deterministic = torch.equal(g.view(torch.int32),
                                gram_mod.gram(x).view(torch.int32))
    err = rel_err(torch, g, ref.gram_ref(x))
    g64 = gram64(torch, x)
    diag64, off64 = corr_err(torch, g, g64)
    plain64 = corr_err(torch, ref.gram_ref(x), g64)
    b = bound(n * p * 4 + p * p * 4, 2 * n * p * p)
    row = dict(
        name="gram", route="cuda", source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/gram.py:54", body=body,
        design=dict(chunk_rows=plan.chunk_rows, stages=plan.stages,
                    splits=plan.splits, rows_per_split=plan.rows_per_split,
                    smem_bytes=plan.smem_bytes,
                    threads=gram_mod.TRI_THREADS,
                    blocks_per_sm=gram_mod.TRI_BLOCKS_PER_SM),
        ptxas=build.ptxas_report("gram", "tri_partialsIfLb1ELb0E"),
        deterministic=deterministic,
        max_abs_err=float((g.double() - g64).abs().max()),
        rel_err=err, tol=1e-4, diag_err_f64=diag64, tol_f64=F64_TOL,
        offdiag_err_f64=off64, tol_offdiag_f64=F64_TOL_OFFDIAG,
        plain_f32_diag_offdiag_err_f64=plain64,
        ms=time_ms(torch, lambda: gram_mod.gram(x)),
        plain_ms=time_ms(torch, lambda: ref.gram_ref(x)),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_ms(torch, lambda: torch.matmul(x.T, x)))
    emit({"phase": "kernel", **row})
    check(body == plan.body == "tri", f"gram ran the {body} body, its plan "
          f"says {plan.body}; the main path's shape takes the triangle")
    check(deterministic, "gram: two calls differ")
    check(err <= 1e-4, f"gram rel err {err} against the f32 plain version")
    check(diag64 <= F64_TOL and off64 <= F64_TOL_OFFDIAG,
          f"gram err {diag64} on the diagonal, {off64} off it (correlation "
          "units) against the f64 plain version")
    rows.append(row)
    del g, g64

    # wgram: the IRLS weights of the first Newton step (beta = 0) are 0.25;
    # use weights that vary per row so the reweighting is exercised.
    gen = torch.Generator(device=x.device)
    gen.manual_seed(SEED + 1)
    w = torch.rand(n, generator=gen, device=x.device) * 0.25 + 1e-6
    tri_before = wg.tri_launches
    g = wg.wgram(x, w)
    plan = gram_mod.tri_plan(n, p, x.dtype, weighted=True)
    body = "tri" if wg.tri_launches > tri_before else "tile"
    err = rel_err(torch, g, ref.wgram_ref(x, w))
    g64 = gram64(torch, x, w)
    diag64, off64 = corr_err(torch, g, g64)
    plain64 = corr_err(torch, ref.wgram_ref(x, w), g64)
    b = bound(n * p * 4 + n * 4 + p * p * 4, 2 * n * p * p + n * p)
    row = dict(
        name="wgram", route="cuda", source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/weighted_gram.py:63", body=body,
        design=dict(chunk_rows=plan.chunk_rows, stages=plan.stages,
                    splits=plan.splits, rows_per_split=plan.rows_per_split,
                    smem_bytes=plan.smem_bytes,
                    threads=gram_mod.TRI_THREADS,
                    blocks_per_sm=gram_mod.TRI_BLOCKS_PER_SM),
        ptxas=build.ptxas_report("gram", "tri_partialsIfLb1ELb1E"),
        max_abs_err=float((g.double() - g64).abs().max()),
        rel_err=err, tol=1e-4, diag_err_f64=diag64, tol_f64=F64_TOL,
        offdiag_err_f64=off64, tol_offdiag_f64=F64_TOL_OFFDIAG,
        plain_f32_diag_offdiag_err_f64=plain64,
        ms=time_ms(torch, lambda: wg.wgram(x, w)),
        plain_ms=time_ms(torch, lambda: ref.wgram_ref(x, w), reps=2),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_ms(torch, lambda: torch.einsum("ni,n,nj->ij", x, w, x),
                           reps=2))
    emit({"phase": "kernel", **row})
    check(body == plan.body, f"wgram ran the {body} body, its plan says "
          f"{plan.body}")
    check(err <= 1e-4, f"wgram rel err {err} against the f32 plain version")
    check(diag64 <= F64_TOL and off64 <= F64_TOL_OFFDIAG,
          f"wgram err {diag64} on the diagonal, {off64} off it (correlation "
          "units) against the f64 plain version")
    rows.append(row)
    del g, g64, w

    # fused_apply_agg: the chains the engine builds for summary().
    X = fm.conv_R2FM(x)
    outs = (fm.colMins(X), fm.colMaxs(X), fm.colSums(X),
            fm.colSums(fm.abs_(X)), fm.colSums(X ** 2),
            fm.agg_col(X, "count_nonzero"))
    units = Plan([o.m for o in outs]).program("cuda").kernel_units
    check([u.kernel for u in units] == ["fused_apply_agg"],
          f"summary plan lowers to {[u.kernel for u in units]}")
    chains = units[0].chains
    ring_before = faa.ring_launches
    got = faa.fused_apply_agg(x, chains)
    body = "ring" if faa.ring_launches > ring_before else "tile"
    plan = faa.chain_plan(n, p, x.dtype)
    deterministic = all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(got, faa.fused_apply_agg(x, chains)))
    want = ref.fused_apply_agg_ref(x, chains)
    err = 0.0
    max_abs = 0.0
    failed = []
    for (unaries, agg, acc), a, r in zip(chains, got, want):
        max_abs = max(max_abs, float((a.double() - r.double()).abs().max()))
        if agg in ("min", "max", "count", "count_nonzero"):
            if not torch.equal(a, r):
                failed.append(f"fused_apply_agg {agg} not exact")
        else:
            e = rel_err(torch, a, r)
            if e > 1e-4:
                failed.append(f"fused_apply_agg {unaries} {agg} rel err {e}")
            err = max(err, e)
    if not body == plan.body == "ring":
        failed.append(f"fused_apply_agg ran the {body} body, its plan says "
                      f"{plan.body}; the main path's shape takes the ring")
    if not deterministic:
        failed.append("fused_apply_agg: two calls differ")
    n_ops = sum(len(u) + 1 for u, _, _ in chains)
    b = bound(n * p * 4 + len(chains) * p * 4, n * p * n_ops)
    row = dict(
        name="fused_apply_agg", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_apply_agg.cu",
        replaces="src/repro/kernels/fused_apply_agg.py:177", body=body,
        design=dict(chunk_rows=plan.chunk_rows, stages=plan.stages,
                    splits=plan.splits, rows_per_split=plan.rows_per_split,
                    lanes=plan.lanes, values_a_decode=faa.RING_V,
                    smem_bytes=plan.smem_bytes, threads=faa.RING_THREADS,
                    blocks_per_sm=faa.RING_BLOCKS_PER_SM),
        ptxas=build.ptxas_report("fused_apply_agg", "chain_ring_partialsILi1E"),
        deterministic=deterministic,
        max_abs_err=max_abs, rel_err=err, tol=1e-4,
        ms=time_ms(torch, lambda: faa.fused_apply_agg(x, chains)),
        plain_ms=time_ms(torch, lambda: ref.fused_apply_agg_ref(x, chains),
                         reps=2),
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        library_note="no single PyTorch call computes several column "
                     "statistics of transformed values in one read; "
                     "torch.aminmax gives min and max alone")
    emit({"phase": "kernel", **row})
    check(not failed, "; ".join(failed))
    rows.append(row)
    del got, want

    # kmeans_assign: the first Lloyd step of kmeans(k=10) on the blobs.
    c = torch.as_tensor(_init_centers(fm.conv_R2FM(xk), K_CLUSTERS, 0),
                        device=x.device)
    tma_before = ka.tma_launches
    lab, sums, cnts, wss = ka.kmeans_assign(xk, c)
    body = "tma" if ka.tma_launches > tma_before else "staged"
    plan = ka.lloyd_plan(n, p, c.shape[0], xk.dtype)
    deterministic = all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip((lab, sums, cnts, wss), ka.kmeans_assign(xk, c)))
    rlab, rsums, rcnts, rwss = ref.kmeans_assign_ref(xk, c)
    failed = []
    if not body == plan.body == "tma":
        failed.append(f"kmeans_assign ran the {body} body, its plan says "
                      f"{plan.body}; the main path's shape takes the TMA one")
    if not deterministic:
        failed.append("kmeans_assign: two calls differ")
    bad = (lab != rlab).nonzero().reshape(-1)
    if bad.numel():
        xb = xk[bad].double()
        cd = c.double()
        da = ((xb - cd[lab[bad].long()]) ** 2).sum(1)
        dr = ((xb - cd[rlab[bad].long()]) ** 2).sum(1)
        tie = (da - dr).abs() <= 1e-5 * torch.maximum(da, dr).clamp_min(1.0)
        if not bool(tie.all()):
            failed.append(f"kmeans labels differ off near-ties "
                          f"({int((~tie).sum())} rows)")
    mism = int(bad.numel())
    if float((cnts - rcnts).abs().sum()) > 2 * mism:
        failed.append("kmeans counts against the f32 plain version")
    e_s = rel_err(torch, sums, rsums)
    e_w = rel_err(torch, wss, rwss)
    if not (e_s <= 1e-4 and e_w <= 1e-4):
        failed.append(f"kmeans sums {e_s} wss {e_w} against the f32 plain "
                      "version")
    # float64, given the kernel's labels: each cluster sum against the sum
    # of |x| it adds up, wss against itself, counts against a bincount.
    s64, a64, c64, w64 = lloyd64(torch, xk, c, lab)
    e_s64 = float(((sums.double() - s64).abs() / a64.clamp_min(1e-300)).max())
    e_w64 = float((wss.double() - w64).abs().max() / w64)
    e_c64 = float(((cnts.double() - c64).abs() / c64.clamp_min(1.0)).max())
    if max(e_s64, e_w64, e_c64) > F64_TOL:
        failed.append(f"kmeans sums {e_s64} wss {e_w64} counts {e_c64} "
                      "against the f64 plain version")
    k = K_CLUSTERS
    b = bound(n * p * 4 + n * 4 + k * p * 4 + (k * p + k + 1) * 4,
              n * (2 * p + 2 * k * p + 3 * k + p))
    row = dict(
        name="kmeans_assign", route="cuda",
        source="src/repro_torch/kernels/csrc/kmeans_assign.cu",
        replaces="src/repro/kernels/kmeans_assign.py:96", body=body,
        design=dict(box_rows=plan.box_rows, stages=plan.stages,
                    blocks=plan.blocks, blocks_per_sm=plan.blocks_per_sm,
                    lanes=plan.lanes, part_smem=plan.part_smem,
                    smem_bytes=plan.smem_bytes, threads=ka.TMA_THREADS,
                    centers_a_pass=ka.TMA_KB, swizzle="128B"),
        ptxas=build.ptxas_report(
            "kmeans_assign",
            f"lloyd_tma_partialsIfLi{p * 4 // 16}ELb{int(plan.part_smem)}E"),
        deterministic=deterministic,
        max_abs_err=max(float((sums.double() - s64).abs().max()),
                        float((wss.double() - w64).abs().max())),
        rel_err=max(e_s, e_w), tol=1e-4, label_mismatches_at_ties=mism,
        sums_err_f64=e_s64, wss_err_f64=e_w64, counts_err_f64=e_c64,
        tol_f64=F64_TOL, wss=[float(wss), float(rwss), float(w64)],
        ms=time_ms(torch, lambda: ka.kmeans_assign(xk, c)),
        plain_ms=time_ms(torch, lambda: ref.kmeans_assign_ref(xk, c), reps=2),
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        library_note="no single PyTorch call gives labels with their "
                     "cluster sums, counts and wss; torch.cdist + argmin "
                     "gives the labels alone")
    emit({"phase": "kernel", **row})
    check(not failed, "; ".join(failed))
    rows.append(row)
    del lab, sums, cnts, wss, rlab, rsums, rcnts, rwss

    # xty at NMF's pass-A shape, WᵀX with W (n, 8) ≥ 0 and |X|, and at
    # GMM's, Xᵀr with r (n, 1) the responsibilities of one component.
    gen.manual_seed(SEED + 2)
    w_nmf = torch.rand((n, NMF_K), generator=gen, device=x.device)
    xa = x.abs()
    row = xty_row(torch, w_nmf, xa, "nmf")
    del w_nmf, xa
    r = torch.rand((n, 1), generator=gen, device=x.device)
    row["at_gmm_shape"] = xty_row(torch, xk, r, "gmm")
    rows.append(row)
    del r
    torch.cuda.empty_cache()
    return rows


def xty64(torch, x, y):
    """XᵀY in float64, a chunk of rows at a time, and the units of its
    entries: sqrt(Σx_i² · Σy_j²)."""
    g = torch.zeros((x.shape[1], y.shape[1]), dtype=torch.float64,
                    device=x.device)
    nx = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    ny = torch.zeros(y.shape[1], dtype=torch.float64, device=x.device)
    for s, e in row_chunks(x.shape[0]):
        xc, yc = x[s:e].double(), y[s:e].double()
        g += xc.T @ yc
        nx += (xc * xc).sum(0)
        ny += (yc * yc).sum(0)
    return g, torch.outer(nx.sqrt(), ny.sqrt()).clamp_min(1e-300)


def xty_row(torch, x, y, shape):
    """The xty kernel on (x, y) against its plain versions; returns its
    row after printing it."""
    from repro_torch.kernels import build, gram as gram_mod, ref
    n, p = x.shape
    q = y.shape[1]
    g = gram_mod.xty(x, y)
    plain = ref.xty_ref(x, y)
    err = rel_err(torch, g, plain)
    g64, units = xty64(torch, x, y)
    e64 = float(((g.double() - g64).abs() / units).max())
    plain64 = float(((plain.double() - g64).abs() / units).max())
    b = bound(n * (p + q) * 4 + p * q * 4, 2 * n * p * q)
    na = gram_mod.thin_width(min(p, q))
    row = dict(
        name="xty", shape=f"{shape}: ({n}, {p})ᵀ·({n}, {q})", route="cuda",
        source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/gram.py:92",
        body=f"thin, narrow width {na}, 16-byte loads",
        splits=gram_mod.xty_plan(n, p, q)[0],
        ptxas=build.ptxas_report("gram", f"xty_thin_partialsIfLi{na}ELb1E"),
        max_abs_err=float((g.double() - g64).abs().max()),
        rel_err=err, tol=1e-4, err_f64=e64, tol_f64=F64_TOL,
        plain_f32_err_f64=plain64,
        ms=time_ms(torch, lambda: gram_mod.xty(x, y)),
        plain_ms=time_ms(torch, lambda: ref.xty_ref(x, y)),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_ms(torch, lambda: torch.matmul(x.T, y)))
    emit({"phase": "kernel", **row})
    check(err <= 1e-4, f"xty ({shape}) rel err {err} against the f32 plain "
          "version")
    check(e64 <= F64_TOL, f"xty ({shape}) err {e64} against the f64 plain "
          "version")
    return row


def small_phase(x, xk, lab):
    """summary, correlation, SVD, PCA and naive Bayes on 4096 rows against
    numpy."""
    import numpy as np
    from repro_torch.algorithms import (correlation, naive_bayes, pca,
                                        summary, svd_tall)
    from repro_torch.core import fm
    xs = x[:4096].cpu().numpy()
    X = fm.conv_R2FM(xs)
    s = summary(X)
    np.testing.assert_allclose(s.mean, xs.mean(0), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(s.var, xs.var(0, ddof=1), rtol=1e-2)
    np.testing.assert_allclose(s.col_min, xs.min(0))
    np.testing.assert_allclose(s.col_max, xs.max(0))
    np.testing.assert_allclose(s.l1, np.abs(xs).sum(0), rtol=1e-3)
    np.testing.assert_array_equal(s.nnz, (xs != 0).sum(0))
    c = correlation(X)
    np.testing.assert_allclose(c, np.corrcoef(xs.T), rtol=2e-2, atol=2e-3)
    r = svd_tall(X, k=6)
    np.testing.assert_allclose(
        r.s, np.linalg.svd(xs.astype(np.float64), compute_uv=False)[:6],
        rtol=1e-3)
    xc = xs.astype(np.float64) - xs.mean(0)
    np.testing.assert_allclose(
        pca(X, k=4).sdev, np.linalg.svd(xc, compute_uv=False)[:4]
        / np.sqrt(xs.shape[0] - 1), rtol=1e-3)
    xks, ls = xk[:4096].cpu().numpy(), lab[:4096].cpu().numpy()
    m = naive_bayes(fm.conv_R2FM(xks), fm.conv_R2FM(ls), K_CLUSTERS)
    for j in range(K_CLUSTERS):
        np.testing.assert_allclose(m.means[j], xks[ls == j].mean(0),
                                   rtol=1e-4, atol=1e-4)
    emit({"phase": "small", "rows": xs.shape[0], "ok": True})


def run_algorithms(torch, x, y, xk):
    from repro_torch.algorithms import correlation, glm, kmeans, summary
    from repro_torch.core import fm
    X, Y, XK = fm.conv_R2FM(x), fm.conv_R2FM(y), fm.conv_R2FM(xk)
    out, wall = {}, {}
    for name, fn in (("summary", lambda: summary(X)),
                     ("correlation", lambda: correlation(X)),
                     ("glm", lambda: glm(X, Y, family="logistic", max_iter=8)),
                     ("kmeans", lambda: kmeans(XK, k=K_CLUSTERS, max_iter=5))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
    return out, wall


def main_phase(torch, x, y, xk):
    import numpy as np
    from repro_torch.core import fm
    from repro_torch.kernels import gram as gram_mod
    with fm.conf(backend="cuda"):
        run_algorithms(torch, x, y, xk)  # warm: plan cache, libraries
        fm.reset_exec_stats()
        gram_mod.tri_launches = 0
        (res, wall), launches = counted(
            torch, "dense main", ("gram", "wgram", "fused_apply_agg",
                                  "kmeans_assign"),
            lambda: run_algorithms(torch, x, y, xk))
    check(gram_mod.tri_launches > 0, "gram never ran its triangle body on "
          "the dense main path")
    st = fm.exec_stats()
    check(st["passes"] == st["materialize_calls"],
          f"passes {st['passes']} != materialize calls "
          f"{st['materialize_calls']}")
    emit({"phase": "main", "backend": "cuda", "wall_s": wall,
          "launches": launches, "passes": st["passes"],
          "materialize_calls": st["materialize_calls"],
          "glm_iters": res["glm"].iters, "kmeans_iters": res["kmeans"].iters})

    with fm.conf(backend="torch"):
        run_algorithms(torch, x, y, xk)
        ref_res, ref_wall = run_algorithms(torch, x, y, xk)
    emit({"phase": "main", "backend": "torch", "wall_s": ref_wall,
          "glm_iters": ref_res["glm"].iters,
          "kmeans_iters": ref_res["kmeans"].iters})

    s, r = res["summary"], ref_res["summary"]
    np.testing.assert_allclose(s.mean, r.mean, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(s.var, r.var, rtol=1e-2)
    np.testing.assert_allclose(s.col_min, r.col_min)
    np.testing.assert_allclose(s.col_max, r.col_max)
    np.testing.assert_allclose(s.l1, r.l1, rtol=1e-3)
    np.testing.assert_array_equal(s.nnz, r.nnz)
    np.testing.assert_allclose(res["correlation"], ref_res["correlation"],
                               rtol=2e-2, atol=2e-3)
    g, gr = res["glm"], ref_res["glm"]
    check(np.isfinite(g.beta).all() and g.beta.shape == (N_COLS,), "glm beta")
    np.testing.assert_allclose(g.beta, gr.beta, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(g.loglik, gr.loglik, rtol=1e-5)
    km, kr = res["kmeans"], ref_res["kmeans"]
    check(np.isfinite(km.centers).all()
          and km.centers.shape == (K_CLUSTERS, N_COLS), "kmeans centers")
    np.testing.assert_allclose(km.wss, kr.wss, rtol=1e-3)
    emit({"phase": "compare", "ok": True,
          "glm_loglik": [g.loglik, gr.loglik],
          "kmeans_wss": [km.wss, kr.wss]})
    return launches, res


def h2d_rates(torch):
    """Host→device copy rates of one 1 GiB copy from pageable memory (what
    ``stage_block``'s synchronous copy of a numpy block pays) and one from
    pinned memory, in bytes/s."""
    import numpy as np
    n = 1 << 28                                   # 2^28 float32: 1 GiB
    dev = torch.device(DEVICE)
    pageable = torch.from_numpy(np.ones(n, np.float32))
    pinned = torch.ones(n, dtype=torch.float32).pin_memory()
    rates = {}
    for name, src in (("pageable", pageable), ("pinned", pinned)):
        src.to(dev)                               # warm: allocate, map
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = src.to(dev, non_blocking=name == "pinned")
        torch.cuda.synchronize()
        rates[name] = n * 4 / (time.perf_counter() - t0)
        check(bool(out[-1] == 1), f"{name} copy")
        del out
    del pageable, pinned
    return rates


#: Seconds counters of the staging pipeline, read a call: the host read
#: (for the prefetcher the fill of its pinned slots), the side stream's
#: host→device copies (device time; the prefetcher only), the compute
#: thread's wait on the staging queue, and its steps and combines.
STAGE_SECONDS = ("stage_read_seconds", "stage_copy_seconds",
                 "prefetch_wait_seconds", "device_step_seconds",
                 "combine_seconds")


def run_ooc(torch, calls, rates, traced=True, disk_rate=None):
    """Each ``(name, mode, fn)`` of ``calls`` traced, with its counters:
    wall time (host clock around a call that ends in a synchronize), the
    passes and their partition rows from the ``pass`` spans, partition
    steps, the bytes read from the host tier, each kernel's launches, and
    a pass's share of the staging pipeline's seconds (``STAGE_SECONDS``:
    fill, copy, wait, step) beside its read floors — the bytes it stages
    over the measured pageable and pinned copy rates (``rates``).  A traced
    step waits for the compute stream (span fidelity), and so for its own
    partition's copy; with ``traced=False`` nothing waits, there are no
    spans, and ``ms_per_pass`` (the call's wall time over its passes) is
    the pipeline's own pace.  With ``disk_rate`` (bytes/s) each call also
    gets ``disk_read_floor_ms``, a pass's staged bytes over that rate, and
    ``pass_bytes_in``, the bytes of the last execution's passes."""
    from repro_torch.core import fm
    from repro_torch.observability import metrics
    from repro_torch.observability.trace import TRACER
    out, info = {}, {}
    for name, mode, fn in calls:
        st0 = fm.exec_stats()
        read0 = metrics.root_counter("stage_bytes_read")
        sec0 = {k: metrics.root_counter(k) for k in STAGE_SECONDS}
        torch.cuda.synchronize()
        k0 = read_counts()
        with fm.trace() if traced else contextlib.nullcontext():
            t0 = time.perf_counter()
            out[name] = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            passes = [e for e in fm.trace_events() if e["name"] == "pass"] \
                if traced else []
        TRACER.reset()  # a span a partition: drop them, keep the passes
        k1 = read_counts()
        st = fm.exec_stats()
        d = {
            "mode": mode, "wall_ms": wall * 1e3,
            "materialize_calls": st["materialize_calls"]
            - st0["materialize_calls"],
            "passes": st["passes"] - st0["passes"],
            "partition_steps": st["partition_steps"] - st0["partition_steps"],
            "stage_bytes_read": int(metrics.root_counter("stage_bytes_read")
                                    - read0),
            "launches": {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]},
            "partition_rows": sorted({e["args"]["partition_rows"]
                                      for e in passes}),
            "pass_ms": [e["dur"] / 1e3 for e in passes],
            "pass_rows": [e["args"]["partition_rows"] for e in passes]}
        n_pass = max(1, d["passes"])
        d["ms_per_pass"] = wall * 1e3 / n_pass
        pass_bytes = d["stage_bytes_read"] / n_pass
        d["read_floor_ms"] = pass_bytes / rates["pageable"] * 1e3
        d["read_floor_pinned_ms"] = pass_bytes / rates["pinned"] * 1e3
        if disk_rate is not None:
            d["disk_read_floor_ms"] = pass_bytes / disk_rate * 1e3
            d["pass_bytes_in"] = list(st["pass_bytes_in"])
        for k in STAGE_SECONDS:
            d[k.replace("_seconds", "_ms_per_pass")] = (
                (metrics.root_counter(k) - sec0[k]) / n_pass * 1e3)
        fill_s = metrics.root_counter("stage_read_seconds") \
            - sec0["stage_read_seconds"]
        d["fill_gb_s"] = d["stage_bytes_read"] / fill_s / 1e9 \
            if fill_s > 0 else None
        info[name] = d
    return out, info


def ooc_phase(torch, x, y, xk, res_a):
    """Path e: the stream and ooc modes.  X, y and the blobs copied to host
    RAM (``fm.conv_R2FM(host=True)``, 8.4 GB each of X and the blobs) and
    streamed out of core by summary, correlation, glm and kmeans: first
    with the partitions staged synchronously (``prefetch=False``), then
    crossprod (with XᵀY) and summary in ``stream`` mode over the
    device-resident X — one counted run — then the four ooc calls again
    under the default ``prefetch`` (the background prefetcher, depth 2), a
    second counted run.  Results against path a's (and for the crossprods
    the same call in whole mode); each call's passes as in whole mode,
    ⌈n / partition rows⌉ steps a pass, and each pass's time against its
    read floors.  The prefetched calls equal the synchronous ones bit for
    bit, with the same launches, passes, steps and bytes read.  Returns the
    two runs' launches."""
    import numpy as np
    from repro_torch.algorithms import correlation, glm, kmeans, summary
    from repro_torch.core import fm
    rates = h2d_rates(torch)
    emit({"phase": "h2d", "bytes": 1 << 30,
          "pageable_gb_s": rates["pageable"] / 1e9,
          "pinned_gb_s": rates["pinned"] / 1e9})
    t0 = time.perf_counter()
    XH = fm.conv_R2FM(x.cpu().numpy(), host=True)
    YH = fm.conv_R2FM(y.cpu().numpy(), host=True)
    XKH = fm.conv_R2FM(xk.cpu().numpy(), host=True)
    check(XH.m.on_host and XKH.m.on_host and XH.m.nbytes() == x.nbytes,
          "the host slabs")
    emit({"phase": "data", "path": "ooc", "host_gib":
          (XH.m.nbytes() + YH.m.nbytes() + XKH.m.nbytes()) / 2**30,
          "seconds": time.perf_counter() - t0})
    X, Y = fm.conv_R2FM(x), fm.conv_R2FM(y)
    ooc_calls = (
        ("summary", "ooc", lambda: summary(XH)),
        ("correlation", "ooc", lambda: correlation(XH)),
        ("glm", "ooc", lambda: glm(XH, YH, family="logistic", max_iter=8)),
        ("kmeans", "ooc", lambda: kmeans(XKH, k=K_CLUSTERS, max_iter=5)))
    calls = ooc_calls + (
        ("crossprod", "stream", lambda: fm.materialize(
            fm.crossprod(X), fm.crossprod(X, Y), mode="stream")),
        ("summary_stream", "stream", lambda: summary(X, mode="stream")))
    with fm.conf(backend="cuda", prefetch=False):
        fm.reset_exec_stats()
        (res, info), launches = counted(
            torch, "stream/ooc", ("gram", "xty", "wgram", "fused_apply_agg",
                                  "kmeans_assign"),
            lambda: run_ooc(torch, calls, rates))
        whole = fm.materialize(fm.crossprod(X), fm.crossprod(X, Y))
    for name, d in info.items():
        emit({"phase": "main", "path": "ooc", "staging": "synchronous",
              "call": name, **d})
        # one pass per materialize, as in whole mode; ⌈n / rows⌉ steps each
        check(d["passes"] == d["materialize_calls"] and d["passes"] > 0,
              f"{name}: passes {d['passes']} != materialize calls "
              f"{d['materialize_calls']}")
        check(d["partition_steps"] == sum(-(-N_ROWS // r)
                                          for r in d["pass_rows"]),
              f"{name}: {d['partition_steps']} partition steps for passes "
              f"of {d['pass_rows']} rows over {N_ROWS}")
        check(all(-(-N_ROWS // r) > 1 for r in d["pass_rows"]),
              f"{name}: a pass ran as one partition")
        check((d["stage_bytes_read"] > 0) == (d["mode"] == "ooc"),
              f"{name}: {d['stage_bytes_read']} bytes read from the host")

    r = res_a["summary"]
    for s in (res["summary"], res["summary_stream"]):
        np.testing.assert_allclose(s.mean, r.mean, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(s.var, r.var, rtol=1e-2)
        np.testing.assert_allclose(s.col_min, r.col_min)
        np.testing.assert_allclose(s.col_max, r.col_max)
        np.testing.assert_allclose(s.l1, r.l1, rtol=1e-3)
        np.testing.assert_array_equal(s.nnz, r.nnz)
    np.testing.assert_allclose(res["correlation"], res_a["correlation"],
                               rtol=2e-2, atol=2e-3)
    g, gr = res["glm"], res_a["glm"]
    check(np.isfinite(g.beta).all() and g.beta.shape == (N_COLS,), "glm beta")
    np.testing.assert_allclose(g.beta, gr.beta, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(g.loglik, gr.loglik, rtol=1e-5)
    km, kr = res["kmeans"], res_a["kmeans"]
    check(np.isfinite(km.centers).all(), "kmeans centers")
    np.testing.assert_allclose(km.wss, kr.wss, rtol=1e-3)
    for a, b in zip(res["crossprod"], whole):
        a, b = (fm._fm(v).logical_data().double() for v in (a, b))
        err = float((a - b).abs().max() / b.abs().max())
        check(err <= 1e-4, f"stream crossprod against whole: {err}")
    emit({"phase": "compare", "path": "ooc", "ok": True,
          "launches": launches, "glm_loglik": [g.loglik, gr.loglik],
          "glm_iters": [g.iters, gr.iters], "kmeans_wss": [km.wss, kr.wss]})

    # The same four calls through the background prefetcher (the default).
    with fm.conf(backend="cuda"):
        check(fm.set_conf()["prefetch"] is True, "prefetch is not the "
              "default")
        fm.reset_exec_stats()
        (pres, pinfo), plaunches = counted(
            torch, "ooc prefetched", ("gram", "wgram", "fused_apply_agg",
                                      "kmeans_assign"),
            lambda: run_ooc(torch, ooc_calls, rates))
    for name, d in pinfo.items():
        emit({"phase": "main", "path": "ooc", "staging": "prefetched",
              "call": name, **d})
    for name, d in pinfo.items():
        sync = info[name]
        for k in ("passes", "partition_steps", "stage_bytes_read",
                  "launches", "pass_rows"):
            check(d[k] == sync[k], f"prefetched {name}: {k} {d[k]} against "
                  f"the synchronous run's {sync[k]}")
        check(d["stage_copy_ms_per_pass"] > 0, f"prefetched {name}: no copy "
              "ran on the side stream")
    diffs = same_results(res, pres, [n for n, _, _ in ooc_calls])
    emit({"phase": "compare", "path": "ooc prefetched",
          "bit_for_bit": not diffs, "differs": diffs,
          "launches": plaunches})
    check(not diffs, f"prefetched results differ from the synchronous "
          f"run's: {diffs}")
    # Untraced, outside the counted runs: the pipeline's own pace, with no
    # step waiting for the compute stream, synchronous then prefetched, on
    # the one-pass calls (summary, correlation; glm's and kmeans' passes
    # are the same sweep, and the traced runs above time them).
    for prefetch in (False, True):
        with fm.conf(backend="cuda", prefetch=prefetch):
            _, uinfo = run_ooc(torch, ooc_calls[:2], rates, traced=False)
        for name, d in uinfo.items():
            emit({"phase": "main", "path": "ooc", "traced": False,
                  "staging": "prefetched" if prefetch else "synchronous",
                  "call": name, **{k: v for k, v in d.items()
                                   if k not in ("pass_ms", "pass_rows",
                                                "partition_rows")}})
    dlaunches = disk_dense_phase(torch, x, y, XH, YH, XKH, pres, pinfo,
                                 rates)
    del XH, YH, XKH, pres
    return [launches, plaunches] + dlaunches


def same_results(a, b, names):
    """The fields (numpy arrays, floats, fm matrices) of each named result
    in ``b`` that are not equal bit for bit to ``a``'s."""
    import numpy as np
    from repro_torch.core import fm
    diffs = []

    def value(v):
        if isinstance(v, (fm.FM, fm.FMMatrix)):
            return fm.as_np(v)
        return np.asarray(v)

    for name in names:
        ra, rb = a[name], b[name]
        fields = (vars(ra) if hasattr(ra, "__dict__")
                  else {f: getattr(ra, f) for f in getattr(
                      ra, "__dataclass_fields__", ())} or {"value": ra})
        for f, va in fields.items():
            vb = getattr(rb, f) if f != "value" else rb
            if va is None and vb is None:
                continue
            if not np.array_equal(value(va), value(vb)):
                diffs.append(f"{name}.{f}")
    return diffs


def stress_phase(torch):
    """The prefetcher under stress, outside the counted paths: a host
    matrix of random data in 512-row partitions (a 256 KiB budget over the
    plan's live values), crossprod and
    colSums with every step delayed by a sleep on the compute stream, at
    depth 1 and 8 — equal to the synchronous run bit for bit; then a
    staging fault mid-stream raises PrefetchError naming the rows and the
    source, and leaves no live prefetcher or staged partition."""
    import numpy as np
    from repro_torch import storage
    from repro_torch.core import fm, materialize
    from repro_torch.core.matrix import DenseStore, FMMatrix
    a = np.random.default_rng(SEED + 7).normal(
        size=(1 << 20, N_COLS)).astype(np.float32)
    step = materialize._member_step

    def slowed(*args, **kw):
        torch.cuda._sleep(200_000)                # ~0.1 ms on the stream
        return step(*args, **kw)

    out = {}
    with fm.conf(backend="cuda", io_partition_bytes=1 << 18):
        X = fm.conv_R2FM(a, host=True)
        materialize._member_step = slowed
        try:
            for depth in (None, 1, 8):
                with fm.conf(prefetch=depth is not None,
                             prefetch_depth=depth):
                    fm.reset_exec_stats()
                    t0 = time.perf_counter()
                    res = fm.materialize(fm.crossprod(X), fm.colSums(X))
                    out[depth] = ([fm.as_np(r) for r in res],
                                  fm.exec_stats()["partition_steps"],
                                  time.perf_counter() - t0)
        finally:
            materialize._member_step = step

        class Flaky(DenseStore):
            reads = 0

            def block(self, start, stop):
                Flaky.reads += 1
                if Flaky.reads > 100:
                    raise OSError("injected staging fault")
                return super().block(start, stop)

        F = fm.FM(FMMatrix(a.shape, a.dtype, store=Flaky(a), name="flaky"))
        raised = None
        try:
            fm.materialize(fm.crossprod(F))
        except storage.PrefetchError as exc:
            raised = str(exc)
    deadline = time.time() + 10
    while time.time() < deadline and storage.live_prefetchers():
        time.sleep(0.02)
    audit = {"live_prefetchers": len(storage.live_prefetchers()),
             "staged_leaks": len(storage.staged_leaks())}
    equal = {d: all(np.array_equal(u, v) for u, v in zip(out[d][0],
                                                         out[None][0]))
             for d in (1, 8)}
    emit({"phase": "stress", "rows": a.shape[0], "partition_steps":
          out[None][1], "seconds": {str(d): out[d][2] for d in out},
          "bit_for_bit": equal, "fault": raised, **audit})
    check(out[None][1] > 100, f"stress: {out[None][1]} partition steps")
    check(all(equal.values()), f"stress: prefetched runs differ {equal}")
    check(raised is not None and "of source 'flaky'" in raised,
          f"stress: the injected fault raised {raised!r}")
    check(audit == {"live_prefetchers": 0, "staged_leaks": 0},
          f"stress: leak audit {audit}")


def run_a8(torch, x, xk, lab):
    """The rest of the dense algorithms, each timed by the host clock around
    a call that ends in a synchronize; GMM's peak device memory with it."""
    from repro_torch.algorithms import (gmm, naive_bayes, nb_predict, nmf,
                                        pca, svd_tall)
    from repro_torch.core import fm, materialize
    X, XK, L = fm.conv_R2FM(x), fm.conv_R2FM(xk), fm.conv_R2FM(lab)
    out, wall = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0

    timed("svd_tall", lambda: svd_tall(X, k=10, compute_u=True))
    # keep what the comparison reads; drop the full-height results
    out["svd_tall"].U = fm._fm(out["svd_tall"].U).logical_data()[:4096].cpu()
    timed("pca", lambda: pca(X, k=10))
    XA = fm.conv_R2FM(x.abs())
    timed("nmf", lambda: nmf(XA, k=NMF_K, max_iter=3))
    out["nmf"].W = None
    del XA
    # cached plans hold their source matrices: drop them with |X|
    materialize.clear_plan_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed("gmm", lambda: gmm(XK, k=K_CLUSTERS, max_iter=3))
    peak = torch.cuda.max_memory_allocated()
    timed("naive_bayes", lambda: naive_bayes(XK, L, K_CLUSTERS))
    timed("nb_predict", lambda: nb_predict(out["naive_bayes"], XK))
    return out, wall, peak


def algorithms_phase(torch, x, xk, lab):
    """Path b: svd_tall, pca, nmf, gmm and naive Bayes on cuda (counted),
    then on torch, compared."""
    import numpy as np
    from repro_torch.core import fm
    with fm.conf(backend="cuda"):
        fm.reset_exec_stats()
        (res, wall, peak), launches = counted(
            torch, "algorithms", ("gram", "xty", "wgram", "fused_apply_agg"),
            lambda: run_a8(torch, x, xk, lab))
    st = fm.exec_stats()
    # every materialize is one pass, but pca's two
    check(st["passes"] == st["materialize_calls"] + 1,
          f"passes {st['passes']} != materialize calls "
          f"{st['materialize_calls']} + 1 (pca)")
    emit({"phase": "main", "path": "algorithms", "backend": "cuda",
          "wall_s": wall, "launches": launches, "passes": st["passes"],
          "materialize_calls": st["materialize_calls"],
          "gmm_rows": N_ROWS, "gmm_max_memory_allocated": peak,
          "gmm_max_memory_gib": peak / 2**30,
          "nmf_iters": res["nmf"].iters, "gmm_iters": res["gmm"].iters})
    with fm.conf(backend="torch"):
        ref, ref_wall, ref_peak = run_a8(torch, x, xk, lab)
    emit({"phase": "main", "path": "algorithms", "backend": "torch",
          "wall_s": ref_wall, "gmm_max_memory_allocated": ref_peak})

    # X ~ N(0, 1): XᵀX ≈ n·I, so its eigenvalues are close together and the
    # eigenvectors move with float32 noise in the Gram; the singular values
    # do not.  Each backend's U is held to its own V: U = X V Σ⁻¹.
    s, r = res["svd_tall"], ref["svd_tall"]
    check(np.isfinite(s.s).all() and s.V.shape == (N_COLS, 10), "svd")
    np.testing.assert_allclose(s.s, r.s, rtol=1e-4)
    x0 = x[:4096].double().cpu().numpy()
    for v in (s, r):
        np.testing.assert_allclose(v.U.double().numpy(), x0 @ v.V / v.s,
                                   rtol=1e-3, atol=1e-7)
    a, b = res["pca"], ref["pca"]
    np.testing.assert_allclose(a.sdev, b.sdev, rtol=1e-4)
    np.testing.assert_allclose(a.center, b.center, rtol=1e-4, atol=1e-6)
    a, b = res["nmf"], ref["nmf"]
    check(np.isfinite(a.H).all() and a.H.shape == (NMF_K, N_COLS), "nmf H")
    np.testing.assert_allclose(a.objective_trace, b.objective_trace,
                               rtol=1e-3)
    np.testing.assert_allclose(a.H, b.H, rtol=1e-2, atol=1e-4)
    a, b = res["gmm"], ref["gmm"]
    check(np.isfinite(a.means).all() and a.covs.shape == (
        K_CLUSTERS, N_COLS, N_COLS), "gmm")
    t = np.array(a.loglik_trace)
    check((np.diff(t) > -1e-2 * np.abs(t[:-1])).all(), f"gmm loglik {t}")
    np.testing.assert_allclose(a.loglik_trace, b.loglik_trace, rtol=1e-4)
    np.testing.assert_allclose(a.weights, b.weights, atol=1e-4)
    a, b = res["naive_bayes"], ref["naive_bayes"]
    np.testing.assert_allclose(a.means, b.means, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(a.variances, b.variances, rtol=1e-3)
    pa, pb = (fm._fm(v).logical_data() for v in (res["nb_predict"],
                                                 ref["nb_predict"]))
    agree = float((pa == pb).float().mean())
    acc = float((pa.reshape(-1) == lab).float().mean())
    check(agree >= 0.9999, f"nb_predict agreement {agree}")
    check(acc > 0.9, f"nb_predict accuracy {acc} on the blobs")
    emit({"phase": "compare", "path": "algorithms", "ok": True,
          "svd_s0": [float(s.s[0]), float(r.s[0])],
          "gmm_loglik": [res["gmm"].loglik, ref["gmm"].loglik],
          "nmf_objective": [res["nmf"].objective, ref["nmf"].objective],
          "nb_predict_agreement": agree, "nb_accuracy": acc})
    return launches


def make_criteo(torch):
    """The Criteo-shaped slab on the card: per column, a bucket drawn from
    P(k) ∝ (k + 1)^-ZIPF_S over CRITEO_BUCKETS buckets, offset to the
    column's block; y ~ Bernoulli(sigmoid(Σ β[col])) with β from the seed."""
    import numpy as np
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n, f, b = CRITEO_ROWS, CRITEO_FACTORS, CRITEO_BUCKETS
    w = np.arange(1, b + 1, dtype=np.float64) ** -ZIPF_S
    cdf = torch.as_tensor(np.cumsum(w) / w.sum(), device=dev)
    beta = torch.as_tensor(np.random.default_rng(SEED).normal(0.0, 0.3, f * b),
                           dtype=torch.float32, device=dev)
    cols = torch.empty((n, f), dtype=torch.int32, device=dev)
    eta = torch.zeros(n, device=dev)
    for j in range(f):
        u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        c = torch.searchsorted(cdf, u).clamp_max_(b - 1) + j * b
        cols[:, j] = c
        eta += beta[c]
        del u, c
    vals = torch.ones((n, f), device=dev)
    eta -= eta.mean()
    y = (torch.rand(n, generator=gen, device=dev)
         < torch.sigmoid(eta)).float().reshape(-1, 1)
    del eta
    torch.cuda.synchronize()
    return cols, vals, y


def sparse_fm(cols, vals):
    """The slab as an fm matrix: the device-tier store fm.one_hot builds."""
    import torch
    from repro_torch.core import fm
    from repro_torch.core.matrix import FMMatrix
    from repro_torch.storage import SparseEllStore
    n, f = cols.shape
    store = SparseEllStore(cols, vals, f * CRITEO_BUCKETS, nnz=n * f)
    return fm.FM(FMMatrix(store.shape, torch.float32, store=store))


def tile_pairs(torch, cols, vals, ts):
    """The shared-memory atomics one spmm_gram / spmm_wgram call makes: per
    row, h_I stored non-zero entries in stripe I of ts columns, and tile
    (I, J), I <= J, takes h_I·h_J of its pairs, so a row adds
    ((Σ h_I)² + Σ h_I²) / 2; counted on the card a chunk of rows at a
    time."""
    ncol = CRITEO_FACTORS * CRITEO_BUCKETS
    nst = -(-ncol // ts)
    total = 0
    for a, b in row_chunks(cols.shape[0]):
        c = cols[a:b].long()
        ok = ((vals[a:b] != 0) & (c >= 0) & (c < ncol)).double()
        h = torch.zeros((b - a, nst + 1), dtype=torch.float64,
                        device=cols.device)
        h.scatter_add_(1, torch.where(ok > 0, c // ts, nst), ok)
        h = h[:, :nst]
        total += int(((h.sum(1) ** 2 + (h * h).sum(1)) / 2).sum())
    return total


def spmm_rows(torch, cols, vals):
    """The three SpMM kernels at the Criteo shape against their plain
    versions (float32 and float64, both a chunk of rows at a time)."""
    from repro_torch.kernels import build, ref, spmm
    n, kmax = cols.shape
    ncol = CRITEO_FACTORS * CRITEO_BUCKETS
    gen = torch.Generator(device=cols.device)
    gen.manual_seed(SEED + 3)
    w = torch.rand(n, generator=gen, device=cols.device) * 0.25 + 1e-6
    z = torch.randn((n, 1), generator=gen, device=cols.device)
    slab = n * kmax * 8
    rows = []
    ts, tiles, splits = spmm.gram_layout(n, ncol)
    design = dict(threads=spmm.GRAM_THREADS, ts=ts, tiles=tiles,
                  splits=splits, rows_in_flight_per_warp=3,
                  body="warp per row; a warp step per in-tile entry of the "
                       "row's I side, the J side's lanes adding (kept over "
                       "numbering the pairs on the lanes, PERF.md)",
                  pair_products=tile_pairs(torch, cols, vals, ts),
                  ptxas=build.ptxas_report("spmm", "spmm_gram_partials"))

    def finish(row, err, e64s, extra_checks=()):
        emit({"phase": "kernel", **row})
        check(err <= 1e-4, f"{row['name']} rel err {err} against the f32 "
              "plain version")
        for what, e in e64s:
            check(e <= F64_TOL, f"{row['name']} {what} err {e} against the "
                  "f64 plain version")
        for ok, what in extra_checks:
            check(ok, f"{row['name']}: {what}")
        rows.append(row)

    # spmm_gram: crossprod(Xs).  For a one-hot slab the diagonal is the
    # level counts, integers a float32 sum holds exactly (< 2^24).
    g = spmm.spmm_gram(cols, vals, ncol=ncol)
    gp = ref.spmm_gram_ref(cols, vals, ncol)
    g64 = ref.spmm_gram_ref(cols, vals, ncol, torch.float64)
    counts = torch.bincount(cols.reshape(-1).long(), minlength=ncol).double()
    d64, o64 = corr_err(torch, g, g64)
    b = bound(slab + ncol * ncol * 4, 2 * n * kmax * kmax)
    row = dict(
        name="spmm_gram", route="cuda",
        source="src/repro_torch/kernels/csrc/spmm.cu",
        replaces="src/repro/kernels/spmm.py:77", design=design,
        max_abs_err=float((g.double() - g64).abs().max()),
        rel_err=rel_err(torch, g, gp), tol=1e-4, diag_err_f64=d64,
        offdiag_err_f64=o64, tol_f64=F64_TOL,
        plain_f32_diag_offdiag_err_f64=corr_err(torch, gp, g64),
        diag_equals_level_counts=bool(torch.equal(g.diagonal().double(),
                                                  counts)),
        ms=time_ms(torch, lambda: spmm.spmm_gram(cols, vals, ncol=ncol),
                   reps=3),
        plain_ms=time_ms(torch, lambda: ref.spmm_gram_ref(cols, vals, ncol),
                         reps=1),
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        library_note="no single PyTorch call: torch.sparse.mm(Xᵀ, X) "
                     "returns a sparse product whose intermediate pair "
                     "products (3.1e10) exceed the card")
    finish(row, row["rel_err"], (("diagonal", d64), ("off-diagonal", o64)),
           ((row["diag_equals_level_counts"], "diagonal is not the level "
             "counts"),))
    units = g64.diagonal().clamp_min(1e-300).sqrt()
    del g, gp, g64

    # spmm_xty: the sparse IRLS XᵀWz (q = 1), against a float64 version in
    # the units sqrt(Σ_r X_rc² · Σ_r z_r²).
    zn = float(z.double().pow(2).sum().sqrt())
    g = spmm.spmm_xty(cols, vals, z, ncol=ncol)
    deterministic = bool(torch.equal(g, spmm.spmm_xty(cols, vals, z,
                                                      ncol=ncol)))
    cs, qc, warps, xtiles, xsplits = spmm.xty_layout(n, ncol, z.shape[1])
    xdesign = dict(warps=warps, stripe_rows=cs, stripe_cols=qc,
                   tiles=xtiles, splits=xsplits,
                   rows_in_flight_per_warp=spmm.XTY_AHEAD,
                   smem_bytes=4 * warps * spmm.xty_copy_floats(cs * qc),
                   swizzle="e + (e >> 6)",
                   body="warp per row, a private stripe a warp, no atomics",
                   ptxas=build.ptxas_report("spmm", "spmm_xty_partials"))
    gp = ref.spmm_xty_ref(cols, vals, z, ncol)
    g64 = ref.spmm_xty_ref(cols, vals, z, ncol, torch.float64)
    e64 = float(((g.double() - g64).abs().reshape(-1) / (units * zn)).max())
    b = bound(slab + n * 4 + ncol * 4, 2 * n * kmax)
    library_ms, note = None, None
    try:
        crow = torch.arange(0, n + 1, dtype=torch.int32,
                            device=cols.device) * kmax
        x_csr = torch.sparse_csr_tensor(crow, cols.reshape(-1),
                                        vals.reshape(-1), size=(n, ncol),
                                        check_invariants=False)
        lib = torch.sparse.mm(x_csr.t(), z)
        note = (f"torch.sparse.mm(Xᵀ, z) over a CSR view of the slab, "
                f"rel err {rel_err(torch, lib, g64)}")
        library_ms = time_ms(torch, lambda: torch.sparse.mm(x_csr.t(), z),
                             reps=1)
        del lib, x_csr, crow
    except (RuntimeError, NotImplementedError) as exc:
        note = f"torch.sparse.mm(Xᵀ, z) failed: {str(exc)[:200]}"
    torch.cuda.empty_cache()
    row = dict(
        name="spmm_xty", route="cuda",
        source="src/repro_torch/kernels/csrc/spmm.cu",
        replaces="src/repro/kernels/spmm.py:121", design=xdesign,
        deterministic=deterministic,
        max_abs_err=float((g.double() - g64).abs().max()),
        rel_err=rel_err(torch, g, gp), tol=1e-4, err_f64=e64,
        tol_f64=F64_TOL,
        ms=time_ms(torch, lambda: spmm.spmm_xty(cols, vals, z, ncol=ncol)),
        plain_ms=time_ms(torch, lambda: ref.spmm_xty_ref(cols, vals, z, ncol),
                         reps=1),
        bound_ms=b[0], bound_by=b[1], library_ms=library_ms,
        library_note=note)
    finish(row, row["rel_err"], (("entry", e64),),
           ((deterministic, "two calls differ"),))
    del g, gp, g64

    # spmm_wgram: the sparse IRLS XᵀWX with weights in (0, 0.25].
    g = spmm.spmm_wgram(cols, vals, w, ncol=ncol)
    gp = ref.spmm_wgram_ref(cols, vals, w, ncol)
    g64 = ref.spmm_wgram_ref(cols, vals, w, ncol, torch.float64)
    d64, o64 = corr_err(torch, g, g64)
    b = bound(slab + n * 4 + ncol * ncol * 4, 2 * n * kmax * kmax + n * kmax)
    row = dict(
        name="spmm_wgram", route="cuda",
        source="src/repro_torch/kernels/csrc/spmm.cu",
        replaces="src/repro/kernels/spmm.py:168", design=design,
        max_abs_err=float((g.double() - g64).abs().max()),
        rel_err=rel_err(torch, g, gp), tol=1e-4, diag_err_f64=d64,
        offdiag_err_f64=o64, tol_f64=F64_TOL,
        plain_f32_diag_offdiag_err_f64=corr_err(torch, gp, g64),
        ms=time_ms(torch, lambda: spmm.spmm_wgram(cols, vals, w, ncol=ncol),
                   reps=3),
        plain_ms=time_ms(torch,
                         lambda: ref.spmm_wgram_ref(cols, vals, w, ncol),
                         reps=1),
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        library_note="no single PyTorch call computes XᵀWX on a sparse X")
    finish(row, row["rel_err"], (("diagonal", d64), ("off-diagonal", o64)))
    del g, gp, g64, w, z
    torch.cuda.empty_cache()
    return rows


def sparse_phase(torch, cols, vals, y):
    """Path c: sparse logistic regression and crossprod over the Criteo
    slab on cuda (counted), then cuda against torch on a prefix."""
    import numpy as np
    from repro_torch.algorithms import glm
    from repro_torch.core import fm
    Xs, Y = sparse_fm(cols, vals), fm.conv_R2FM(y)
    ncol = Xs.ncol

    def run():
        wall = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = glm(Xs, Y, "logistic", ridge=1e-3, max_iter=8)
        torch.cuda.synchronize()
        wall["glm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        (G,) = fm.materialize(fm.crossprod(Xs))
        torch.cuda.synchronize()
        wall["crossprod"] = time.perf_counter() - t0
        return g, G, wall

    with fm.conf(backend="cuda"):
        fm.reset_exec_stats()
        (g, G, wall), launches = counted(
            torch, "sparse", ("spmm_gram", "spmm_xty", "spmm_wgram"), run)
    st = fm.exec_stats()
    check(st["passes"] == st["materialize_calls"],
          f"passes {st['passes']} != materialize calls "
          f"{st['materialize_calls']}")
    t = np.array(g.loglik_trace)
    step = abs(t[-1] - t[-2]) / abs(t[-2]) if len(t) > 1 else 0.0
    check(np.isfinite(g.beta).all() and g.beta.shape == (ncol,), "glm beta")
    check((np.diff(t) > -1e-6 * np.abs(t[:-1])).all(),
          f"sparse glm log-likelihood fell: {t}")
    check(g.converged or step <= 1e-6, f"sparse glm did not converge: {t}")
    gd = fm._fm(G).logical_data()
    counts = torch.bincount(cols.reshape(-1).long(), minlength=ncol).float()
    block = torch.block_diag(*[torch.ones(CRITEO_BUCKETS, CRITEO_BUCKETS,
                                          device=gd.device)] * CRITEO_FACTORS)
    check(torch.equal(gd.diagonal(), counts), "crossprod diagonal is not the "
          "level counts")
    check(bool((gd * (block - torch.eye(ncol, device=gd.device)) == 0).all()),
          "crossprod has non-zero entries between levels of one column")
    emit({"phase": "main", "path": "sparse", "backend": "cuda",
          "wall_s": wall, "launches": launches, "passes": st["passes"],
          "materialize_calls": st["materialize_calls"], "glm_iters": g.iters,
          "glm_converged": g.converged, "glm_loglik_trace": list(t),
          "rows": CRITEO_ROWS, "ncol": ncol,
          "slab_gib": (cols.nbytes + vals.nbytes) / 2**30})

    # The slab streamed from the device tier a partition at a time: each
    # SpMM kernel per partition, the Gram equal to whole mode's bit for bit
    # (integer sums under 2^24); a fit on the first SPARSE_STREAM_ROWS rows,
    # its log-likelihoods as a whole-mode fit's within 1e-4: each is a
    # float32 sum of ~1,000 partition partials, every addition rounding at
    # the sum's own ulp.
    m = SPARSE_STREAM_ROWS
    Xm, Ym = sparse_fm(cols[:m], vals[:m]), fm.conv_R2FM(y[:m])

    def run_stream():
        wall = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g2 = glm(Xm, Ym, "logistic", ridge=1e-3, max_iter=2, mode="stream")
        torch.cuda.synchronize()
        wall["glm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        (Gs,) = fm.materialize(fm.crossprod(Xs), mode="stream")
        torch.cuda.synchronize()
        wall["crossprod"] = time.perf_counter() - t0
        return g2, Gs, wall

    with fm.conf(backend="cuda"):
        fm.reset_exec_stats()
        (gs, Gs, swall), slaunches = counted(
            torch, "sparse stream", ("spmm_gram", "spmm_xty", "spmm_wgram"),
            run_stream)
        sst = fm.exec_stats()
        gw = glm(Xm, Ym, "logistic", ridge=1e-3, max_iter=2)
    emit({"phase": "main", "path": "sparse", "mode": "stream",
          "backend": "cuda", "wall_s": swall, "launches": slaunches,
          "passes": sst["passes"], "partition_steps": sst["partition_steps"],
          "materialize_calls": sst["materialize_calls"], "glm_rows": m,
          "glm_loglik_trace": [gs.loglik_trace, gw.loglik_trace]})
    check(sst["passes"] == sst["materialize_calls"]
          and sst["partition_steps"] > sst["passes"],
          f"sparse stream: {sst['passes']} passes, "
          f"{sst['partition_steps']} partition steps")
    check(torch.equal(fm._fm(Gs).logical_data(), gd),
          "the streamed crossprod differs from whole mode's")
    np.testing.assert_allclose(gs.loglik_trace, gw.loglik_trace, rtol=1e-4)
    hlaunches = host_slab_phase(torch, Xs, Xm, Ym, gd, gs, y)
    launches = {k: launches[k] + slaunches[k] + hlaunches[k]
                for k in launches}
    del G, Gs, gd, block, Xm, Ym

    m = SPARSE_CMP_ROWS
    Xp, Yp = sparse_fm(cols[:m], vals[:m]), fm.conv_R2FM(y[:m])
    fits, pwall = {}, {}
    for backend in ("cuda", "torch"):
        with fm.conf(backend=backend):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fits[backend] = glm(Xp, Yp, "logistic", ridge=1e-3, max_iter=8)
            torch.cuda.synchronize()
            pwall[backend] = time.perf_counter() - t0
    a, b = fits["cuda"], fits["torch"]
    # A one-hot design is rank-deficient — each column's 64 levels sum to
    # the same all-ones vector — so beta is fixed only up to that null space,
    # there by the tiny ridge alone, and float32 sums taken in another order
    # move it along it.  The linear predictor Xβ and the log-likelihood are
    # identifiable: those are compared.
    eta = [fm._fm(fm.materialize(Xp @ f.beta.astype(np.float32).reshape(
        -1, 1))[0]).logical_data() for f in (a, b)]
    eta_diff = float((eta[0] - eta[1]).abs().max())
    beta_diff = float(np.abs(a.beta - b.beta).max())
    ll_rel = abs(a.loglik - b.loglik) / abs(b.loglik)
    emit({"phase": "compare", "path": "sparse", "rows": m, "wall_s": pwall,
          "loglik": [a.loglik, b.loglik], "loglik_rel_diff": ll_rel,
          "eta_max_abs_diff": eta_diff, "beta_max_abs_diff": beta_diff})
    check(eta_diff < 1e-2, f"sparse glm linear predictor differs by "
          f"{eta_diff}")
    check(ll_rel < 1e-5, f"sparse glm log-likelihood differs by {ll_rel}")
    return launches


def host_slab_phase(torch, Xs, Xm, Ym, gd, gs, y):
    """Path c from host RAM: the slab copied to the host tier as the
    ``SparseEllStore`` that ``fm.one_hot(host=True)`` builds
    (``fm.persist(tier="host")``: cols / vals as numpy), then streamed
    ``ooc`` through the prefetcher — ``crossprod`` over all of it, equal to
    whole mode's Gram ``gd`` bit for bit with ``spmm_gram`` once a
    partition, and ``glm(max_iter=2)`` over the first SPARSE_STREAM_ROWS
    rows, its log-likelihoods within 1e-4 of the device slab's ``stream``
    fit ``gs``.  Counted; each pass against its read floors."""
    import numpy as np
    from repro_torch.algorithms import glm
    from repro_torch.core import fm
    rates = h2d_rates(torch)
    t0 = time.perf_counter()
    XH, XmH = fm.persist(Xs, tier="host"), fm.persist(Xm, tier="host")
    check(XH.m.is_sparse and XH.m.on_host and XmH.m.on_host
          and isinstance(XH.m.store.vals, np.ndarray)
          and XH.m.nbytes() == Xs.m.nbytes(), "the host slab")
    emit({"phase": "data", "path": "sparse host", "host_gib":
          (XH.m.nbytes() + XmH.m.nbytes()) / 2**30, "pageable_gb_s":
          rates["pageable"] / 1e9, "pinned_gb_s": rates["pinned"] / 1e9,
          "seconds": time.perf_counter() - t0})
    calls = (
        ("crossprod", "ooc", lambda: fm.materialize(fm.crossprod(XH),
                                                    mode="ooc")),
        ("glm", "ooc", lambda: glm(XmH, Ym, "logistic", ridge=1e-3,
                                   max_iter=2, mode="ooc")))
    with fm.conf(backend="cuda"):
        fm.reset_exec_stats()
        (res, info), launches = counted(
            torch, "sparse host", ("spmm_gram", "spmm_xty", "spmm_wgram"),
            lambda: run_ooc(torch, calls, rates))
    for name, d in info.items():
        emit({"phase": "main", "path": "sparse", "mode": "ooc",
              "staging": "prefetched", "call": name, **d})
    d = info["crossprod"]
    check(d["launches"].get("spmm_gram") == d["partition_steps"] > 1,
          f"host-slab crossprod: spmm_gram {d['launches']} for "
          f"{d['partition_steps']} partitions")
    check(d["stage_bytes_read"] == XH.m.nbytes(), f"host-slab crossprod "
          f"read {d['stage_bytes_read']} bytes of {XH.m.nbytes()}")
    same = bool(torch.equal(fm._fm(res["crossprod"][0]).logical_data(), gd))
    gh = res["glm"]
    emit({"phase": "compare", "path": "sparse host", "crossprod_bit_for_bit":
          same, "glm_loglik_trace": [gh.loglik_trace, gs.loglik_trace]})
    check(same, "the host slab's crossprod differs from whole mode's")
    np.testing.assert_allclose(gh.loglik_trace, gs.loglik_trace, rtol=1e-4)
    del XmH, res
    blaunches = batch_sparse_phase(torch, XH, y, gd)
    ilaunches = shard_sparse_arm(torch, Xs, XH, Xm, Ym, gd, gs,
                                 d["partition_steps"])
    claunches = disk_csr_phase(torch, XH, gd, rates)
    del XH
    return {k: launches[k] + blaunches[k] + ilaunches[k] + claunches[k]
            for k in launches}


# ---------------------------------------------------------------------------
# Path f: the disk tier
# ---------------------------------------------------------------------------

def mount_of(path) -> tuple:
    """(mount point, file-system type) of ``path``: the longest mount
    point of /proc/mounts that contains it."""
    real = os.path.realpath(path)
    best = ("/", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt, fstype = parts[1], parts[2]
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best[0]):
                best = (mnt, fstype)
    return best


def drop_file_cache(path):
    """Make the next read of ``path`` cold, as far as the kernel lets us:
    ``fsync`` (``posix_fadvise(DONTNEED)`` leaves dirty pages in the page
    cache), then drop the file's pages."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def read_rates(store) -> dict:
    """Sequential read rates (bytes/s) of the first 1 GiB of a dense
    ``.fmat``'s body, cold (after ``drop_file_cache``) then warm: through
    its memory map, as ``MmapStore.block`` reads it, and through
    ``readinto`` in 64 MiB chunks."""
    import numpy as np
    nbytes = DISK_RATE_ROWS * N_COLS * 4
    out = {}
    for cache in ("cold", "warm"):
        if cache == "cold":
            drop_file_cache(store.path)
        t0 = time.perf_counter()
        blk = np.array(store._mm[:DISK_RATE_ROWS])
        out[f"{cache}_mmap"] = nbytes / (time.perf_counter() - t0)
        check(blk.nbytes == nbytes, "the 1 GiB read")
        del blk
    buf = bytearray(64 << 20)
    for cache in ("cold", "warm"):
        if cache == "cold":
            drop_file_cache(store.path)
        t0 = time.perf_counter()
        with open(store.path, "rb", buffering=0) as f:
            f.seek(store.header.body_offset)
            left = nbytes
            while left:
                left -= f.readinto(memoryview(buf)[:min(left, len(buf))])
        out[f"{cache}_readinto"] = nbytes / (time.perf_counter() - t0)
    return out


def disk_line(path, write_bytes, write_s, rates) -> dict:
    """The ``disk`` line: where path f's files live and how fast that
    disk moved them in this run."""
    mnt, fstype = mount_of(path)
    st = os.statvfs(path)
    line = {"phase": "disk", "dir": str(path), "mount": mnt,
            "fs_type": fstype, "free_bytes": st.f_bavail * st.f_frsize,
            "write_bytes": write_bytes,
            "write_gb_s": write_bytes / write_s / 1e9,
            "read_bytes": DISK_RATE_ROWS * N_COLS * 4}
    line.update({f"{k}_gb_s": v / 1e9 for k, v in rates.items()})
    emit(line)
    return line


def disk_setup(torch):
    """Point the registry at DISK_DIR and check it has room for path f."""
    from repro_torch.core import fm
    DISK_DIR.mkdir(parents=True, exist_ok=True)
    fm.set_conf(data_dir=str(DISK_DIR))
    st = os.statvfs(DISK_DIR)
    free = st.f_bavail * st.f_frsize
    check(free >= DISK_NEED, f"path f needs {DISK_NEED} bytes free under "
          f"{DISK_DIR} ({mount_of(DISK_DIR)}); {free} are free")


def disk_cleanup():
    """Remove path f's files (the directory itself stays, empty)."""
    for p in DISK_DIR.iterdir() if DISK_DIR.exists() else ():
        shutil.rmtree(p) if p.is_dir() else p.unlink()


def compare_to_host(name, d, ref, diffs_fields):
    """One disk call's counters against path e's prefetched host call."""
    for k in ("passes", "partition_steps", "stage_bytes_read", "launches",
              "pass_rows"):
        if d[k] != ref[k]:
            diffs_fields.append(f"{name}.{k}: {d[k]} != {ref[k]}")


def disk_dense_phase(torch, x, y, XH, YH, XKH, pres, pinfo, rates):
    """Path f, dense: X and y written to ``.fmat`` files on the machine's
    disk with ``fm.save_dense_matrix`` (the ``disk`` line: mount, file
    system, free bytes, write rate, cold and warm 1 GiB read rates) and
    reopened with ``fm.get_dense_matrix``; summary, correlation and glm run
    ``ooc`` from them through the prefetcher warm, summary and correlation
    cold (``direct_io``, after fsync + drop), and correlation cold with
    ``prefetch=False``; each
    result equal to path e's prefetched host-tier result ``pres`` bit for
    bit with its counters (``pinfo``), each pass beside its disk read
    floor.  Then ``scale(X, save="disk")`` spills pass 2 to a file,
    checked by its size, its header, a summary from disk and 4096 rows
    against float64.  Counted; the files are removed at the end."""
    import numpy as np
    from repro_torch.algorithms import correlation, glm, summary
    from repro_torch.core import fm
    t_path = time.perf_counter()
    disk_setup(torch)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        XD = fm.save_dense_matrix(x, "friendster_x")
        write_s = time.perf_counter() - t0
        YD = fm.save_dense_matrix(y, "friendster_y")
        check(XD.m.on_disk and YD.m.on_disk and XD.shape == (N_ROWS, N_COLS)
              and YD.shape == (N_ROWS, 1), "the disk matrices")
        XD, YD = fm.get_dense_matrix("friendster_x"), \
            fm.get_dense_matrix("friendster_y")
        disk = disk_line(DISK_DIR, XD.m.nbytes(), write_s,
                         read_rates(XD.m.store))
        cold_rate = max(disk["cold_mmap_gb_s"],
                        disk["cold_readinto_gb_s"]) * 1e9
        DISK_COLD_RATE["bytes_s"] = cold_rate
        calls = (
            ("summary", "ooc", lambda: summary(XD)),
            ("correlation", "ooc", lambda: correlation(XD)),
            ("glm", "ooc", lambda: glm(XD, YD, family="logistic",
                                       max_iter=8)))

        def cold():
            for m in (XD, YD):
                drop_file_cache(m.m.store.path)

        def run():
            out = {}
            with fm.conf(backend="cuda"):
                out["warm"] = run_ooc(torch, calls, rates,
                                      disk_rate=cold_rate)
                cold()
                with fm.conf(direct_io=True):
                    out["cold"] = run_ooc(torch, calls[:2], rates,
                                          disk_rate=cold_rate)
                cold()
                with fm.conf(direct_io=True, prefetch=False):
                    out["cold_sync"] = run_ooc(torch, calls[1:2], rates,
                                               disk_rate=cold_rate)
                out["scale"] = scale_to_disk(torch, XD, XH, x)
            return out

        fm.reset_exec_stats()
        out, launches = counted(torch, "disk dense",
                                ("gram", "wgram", "fused_apply_agg"), run)
        diffs = []
        for run_name, staging in (("warm", "prefetched"),
                                  ("cold", "prefetched"),
                                  ("cold_sync", "synchronous")):
            res, info = out[run_name]
            for name, d in info.items():
                emit({"phase": "main", "path": "disk", "staging": staging,
                      "cache": run_name.split("_")[0], "call": name, **d})
                compare_to_host(f"{run_name} {name}", d, pinfo[name], diffs)
                check(d["pass_bytes_in"][-1] == XD.m.nbytes()
                      + (YD.m.nbytes() if name == "glm" else 0),
                      f"disk {name}: pass_bytes_in {d['pass_bytes_in']}")
            diffs += [f"{run_name} {f}" for f in
                      same_results(pres, res, list(info))]
        emit({"phase": "compare", "path": "disk", "bit_for_bit": not diffs,
              "differs": diffs, "launches": launches})
        check(not diffs, f"disk results differ from path e's prefetched "
              f"host-tier results: {diffs}")
        emit({"phase": "main", "path": "disk", "call": "scale_save_disk",
              **out["scale"]})
        glaunches, gres = batch_dense_phase(torch, x, y, XH, YH, XD, YD)
        hlaunches = serve_phase(torch, x, XH, YH, XKH, XD, YD, gres)
        ilaunches = shard_dense_phase(torch, x, y, XH, YH, gres)
        return [launches, glaunches, hlaunches, ilaunches]
    finally:
        fm.set_conf(direct_io=False)
        disk_cleanup()
        emit({"phase": "data", "path": "disk", "half": "dense",
              "seconds": time.perf_counter() - t_path})


def scale_to_disk(torch, XD, XH, x) -> dict:
    """``scale(X, save="disk")`` from the disk matrix: two passes, pass
    2's sweep written through to a spill file; the file's size and header,
    a summary of the spilled matrix from disk (means within 1e-5 of 0, sds
    within 1e-5 of 1) and 4096 random rows against a float64
    recomputation from X's host copy."""
    import numpy as np
    from repro_torch import storage
    from repro_torch.algorithms import summary
    from repro_torch.core import fm
    st0 = fm.exec_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (Z,) = fm.materialize(fm.scale(XD, save="disk"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = fm.exec_stats()
    passes = st["passes"] - st0["passes"]
    store = Z.m.store
    check(Z.m.on_disk and passes == 2, f"scale spill: on disk "
          f"{Z.m.on_disk}, {passes} passes")
    size = store.path.stat().st_size
    h = storage.read_header(store.path)
    check(size == h.body_offset + N_ROWS * N_COLS * 4
          and (h.nrow, h.ncol, h.layout) == (N_ROWS, N_COLS, "row")
          and h.dtype == np.float32, f"spill file {size} bytes, {h}")
    t1 = time.perf_counter()
    sm = summary(Z)
    torch.cuda.synchronize()
    summary_s = time.perf_counter() - t1
    mean_err = float(np.abs(sm.mean).max())
    sd_err = float(np.abs(np.sqrt(sm.var) - 1.0).max())
    # float64 column moments on the card, the rows from X's host copy
    s1 = torch.zeros(N_COLS, dtype=torch.float64, device=x.device)
    s2 = torch.zeros_like(s1)
    for a, b in row_chunks(N_ROWS):
        xc = x[a:b].double()
        s1 += xc.sum(0)
        s2 += (xc * xc).sum(0)
    mu = (s1 / N_ROWS).cpu().numpy()
    sd = np.sqrt(((s2 - N_ROWS * (s1 / N_ROWS) ** 2) / (N_ROWS - 1))
                 .cpu().numpy())
    rows = np.sort(np.random.default_rng(SEED + 9).choice(
        N_ROWS, 4096, replace=False))
    host = XH.m.logical_data()
    want = (host[rows].astype(np.float64) - mu) / sd
    got = np.asarray(store.logical()[rows], np.float64)
    row_err = float(np.abs(got - want).max())
    out = {"wall_ms": wall * 1e3, "passes": passes,
           "partition_steps": st["partition_steps"] - st0["partition_steps"],
           "pass_bytes_in": list(st["pass_bytes_in"]),
           "spill_bytes": size, "summary_from_disk_ms": summary_s * 1e3,
           "mean_max_abs": mean_err, "sd_max_abs_err": sd_err,
           "rows_checked": len(rows), "rows_max_abs_err_f64": row_err}
    check(mean_err <= 1e-5 and sd_err <= 1e-5, f"scale spill moments: {out}")
    check(row_err <= 1e-5, f"scale spill rows against float64: {out}")
    return out


def disk_csr_phase(torch, XH, gd, rates):
    """Path f, sparse: the host slab written as a CSR ``.fmat``
    (``fm.persist(tier="disk")``), reopened by name and ``crossprod``-ed
    ``ooc`` through the prefetcher warm and cold: ``spmm_gram`` once a
    partition, the Gram equal to whole mode's ``gd`` bit for bit, and
    ``pass_bytes_in`` beside the file's size.  Counted; the file is removed
    at the end."""
    from repro_torch.core import fm
    t_path = time.perf_counter()
    disk_setup(torch)
    try:
        t0 = time.perf_counter()
        fm.persist(XH, tier="disk", name="criteo")
        write_s = time.perf_counter() - t0
        XC = fm.get_dense_matrix("criteo")
        size = XC.m.store.path.stat().st_size
        check(XC.m.on_disk and XC.m.is_sparse and size == 4096
              + XC.m.nbytes(), f"the CSR file: {XC.m.store}, {size} bytes")
        emit({"phase": "data", "path": "disk csr", "file_bytes": size,
              "nnz": XC.m.store.nnz, "write_s": write_s,
              "write_gb_s": size / write_s / 1e9,
              "mount": list(mount_of(DISK_DIR))})
        calls = (("crossprod", "ooc", lambda: fm.materialize(
            fm.crossprod(XC), mode="ooc")),)

        def run():
            with fm.conf(backend="cuda"):
                rate = DISK_COLD_RATE["bytes_s"]
                warm = run_ooc(torch, calls, rates, disk_rate=rate)
                drop_file_cache(XC.m.store.path)
                cold = run_ooc(torch, calls, rates, disk_rate=rate)
            return warm, cold

        fm.reset_exec_stats()
        (warm, cold), launches = counted(torch, "disk csr", ("spmm_gram",),
                                         run)
        for cache, (res, info) in (("warm", warm), ("cold", cold)):
            d = info["crossprod"]
            same = bool(torch.equal(
                fm._fm(res["crossprod"][0]).logical_data(), gd))
            emit({"phase": "main", "path": "disk csr", "cache": cache,
                  "staging": "prefetched", "call": "crossprod",
                  "file_bytes": size, "bit_for_bit": same, **d})
            check(d["launches"].get("spmm_gram") == d["partition_steps"] > 1,
                  f"CSR crossprod ({cache}): spmm_gram {d['launches']} for "
                  f"{d['partition_steps']} partitions")
            check(same, f"the CSR file's crossprod ({cache}) differs from "
                  "whole mode's")
            check(d["pass_bytes_in"] == [XC.m.nbytes()] == [size - 4096],
                  f"CSR crossprod ({cache}): pass_bytes_in "
                  f"{d['pass_bytes_in']}, file {size} bytes")
        return launches
    finally:
        disk_cleanup()
        emit({"phase": "data", "path": "disk", "half": "csr",
              "seconds": time.perf_counter() - t_path})


# ---------------------------------------------------------------------------
# Path g: fm.batch — one partition stream shared by k plans
# ---------------------------------------------------------------------------

#: Path g's dense outputs in the order a batch returns them (flattened), and
#: the request each belongs to.
BATCH_OUTPUTS = ("colMeans", "colSds", "crossprod", "sum_", "crossprod_xy")
BATCH_MEMBER = (0, 1, 1, 2, 3)


def dense_requests(fm, X, Y):
    """Path g's dense requests: the reference's doc example over X —
    colMeans, (colSds, crossprod), sum_ — plus XᵀY, whose {X, y} stream the
    first three ride by the subset rule."""
    return [fm.colMeans(X), (fm.colSds(X), fm.crossprod(X)), fm.sum_(X),
            fm.crossprod(X, Y)]


def outs_of(req):
    return req if isinstance(req, tuple) else (req,)


def group_rows(reqs):
    """(the group's partition rows, each member's own): a member's rows are
    its plan's, the group's those of the members' ``GroupProgram`` (the
    smallest)."""
    from repro_torch.core import lowering
    from repro_torch.core.fusion import Plan
    members = []
    for req in reqs:
        plan = Plan([o.m for o in outs_of(req)])
        members.append((plan.passes[0], plan.program("cuda")))
    return (lowering.GroupProgram(members).partition_rows,
            [ps.partition_rows for ps, _ in members])


def run_serial(fm, make, mode):
    """Each request of ``make()`` as its own materialize: the results,
    flattened, and each execution's pass bytes."""
    vals, pass_bytes = [], []
    for req in make():
        vals += fm.materialize(*outs_of(req), mode=mode)
        pass_bytes += fm.exec_stats()["pass_bytes_in"]
    return vals, pass_bytes


def run_batched(fm, make, mode):
    """The requests of ``make()`` as one ``fm.batch``."""
    vals = []
    for r in fm.batch(*make(), mode=mode):
        vals += r if isinstance(r, list) else [r]
    return vals, list(fm.exec_stats()["pass_bytes_in"])


def measure(torch, fn):
    """One untraced call of ``fn``: its results as device tensors, and its
    wall ms (host clock around a call that ends in a synchronize) with the
    counters it moved — streams, passes, partition steps, each execution's
    pass bytes, the bytes read from the host or disk tier, reuse hits, each
    kernel's launches and the staging pipeline's seconds a stream (fill,
    side-stream copy, queue wait; ``device_step`` is the steps' host time:
    untraced, nothing waits for the card)."""
    from repro_torch.core import fm
    from repro_torch.observability import metrics
    st0 = fm.exec_stats()
    read0 = metrics.root_counter("stage_bytes_read")
    sec0 = {k: metrics.root_counter(k) for k in STAGE_SECONDS}
    torch.cuda.synchronize()
    k0 = read_counts()
    t0 = time.perf_counter()
    vals, pass_bytes = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = read_counts()
    st = fm.exec_stats()
    d = {"wall_ms": wall * 1e3, "pass_bytes_in": pass_bytes,
         "stage_bytes_read": int(metrics.root_counter("stage_bytes_read")
                                 - read0),
         "launches": {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]}}
    for k in ("streams", "passes", "partition_steps", "prefetch_reuse_hits"):
        d[k] = st[k] - st0[k]
    for k in STAGE_SECONDS:
        d[k.replace("_seconds", "_ms_per_stream")] = (
            (metrics.root_counter(k) - sec0[k]) / max(1, d["streams"]) * 1e3)
    return [fm._fm(v).logical_data() for v in vals], d


def max_rel_diff(a, b) -> float:
    """max over entries of |a − b| / |b| (0 where both are 0)."""
    d = (a.double() - b.double()).abs()
    return float((d / b.double().abs().clamp_min(1e-300)).max())


def max_norm_diff(a, b) -> float:
    """max |a − b| / max |b|: the difference in the units of the output's
    largest entry."""
    b = b.double()
    return float((a.double() - b).abs().max() / b.abs().max().clamp_min(
        1e-300))


def batch_tier(torch, tier, X, Y, mode):
    """One dense tier of path g: the requests as four solo materializes,
    then as one ``fm.batch``, each once warm and then measured; each member
    whose own partition rows differ from the group's also runs alone at the
    group's rows.  Returns the two runs' lines and the comparison line."""
    from repro_torch.core import fm
    from repro_torch.core.fusion import Plan

    def make():
        return dense_requests(fm, X, Y)

    grows, mrows = group_rows(make())
    runs = {}
    for run, fn in (("serial", run_serial), ("batched", run_batched)):
        fn(fm, make, mode)                                  # warm
        runs[run] = measure(torch, lambda: fn(fm, make, mode))
    # A member alone at the group's partition rows (its I/O budget scaled):
    # what batching alone changes, with the partitioning held equal.
    alone = {}
    budget = fm.set_conf()["io_partition_bytes"]
    for i, req in enumerate(make()):
        if mode != "whole" and mrows[i] != grows:
            with fm.conf(io_partition_bytes=budget * grows // mrows[i]):
                check(Plan([o.m for o in outs_of(req)]).passes[0]
                      .partition_rows == grows, f"{tier}: member {i} alone")
                alone[i] = [fm._fm(v).logical_data() for v in
                            fm.materialize(*outs_of(req), mode=mode)]
    (bvals, bd), (svals, sd) = runs["batched"], runs["serial"]
    same, rel, norm, same_alone = [], {}, {}, []
    pos = {i: 0 for i in alone}
    for name, member, b, s in zip(BATCH_OUTPUTS, BATCH_MEMBER, bvals,
                                  svals):
        rel[name], norm[name] = max_rel_diff(b, s), max_norm_diff(b, s)
        if torch.equal(b, s):
            same.append(name)
        if member in alone:
            same_alone.append((name, torch.equal(
                b, alone[member][pos[member]])))
            pos[member] += 1
    rows = {"group_rows": grows if mode != "whole" else X.nrow,
            "member_rows": mrows if mode != "whole" else [X.nrow] * 4}
    lines = [{"phase": "main", "path": "batch", "tier": tier, "mode": mode,
              "run": run, **rows, **runs[run][1]} for run in runs]
    cmp = {"phase": "compare", "path": "batch", "tier": tier,
           "speedup": sd["wall_ms"] / bd["wall_ms"],
           "bit_for_bit": same,
           "rows_equal": [n for n, m in zip(BATCH_OUTPUTS, BATCH_MEMBER)
                          if mode == "whole" or mrows[m] == grows],
           "bit_for_bit_alone_at_group_rows": same_alone,
           "max_rel_diff": rel, "max_norm_diff": norm}
    return lines, cmp, (bvals, svals, bd, sd, grows, mrows)


def check_batch_tier(tier, X, Y, mode, cmp, detail):
    """The checks of one dense tier (applied after its lines are
    printed)."""
    bvals, svals, bd, sd, grows, mrows = detail
    nbytes = X.m.nbytes() + Y.m.nbytes()
    check(bd["streams"] == 1 and bd["passes"] == 4,
          f"batch {tier}: {bd['streams']} streams, {bd['passes']} passes")
    check(sd["streams"] == 4 and sd["passes"] == 4,
          f"serial {tier}: {sd['streams']} streams, {sd['passes']} passes")
    check(bd["pass_bytes_in"] == [nbytes], f"batch {tier}: pass_bytes_in "
          f"{bd['pass_bytes_in']}, X and y {nbytes}")
    if mode == "ooc":
        check(bd["stage_bytes_read"] == nbytes
              and sd["stage_bytes_read"] == 3 * X.m.nbytes() + nbytes,
              f"{tier}: read {bd['stage_bytes_read']} batched, "
              f"{sd['stage_bytes_read']} serially")
    parts = 1 if mode == "whole" else -(-X.nrow // grows)
    lb = bd["launches"]
    check(lb.get("gram") == parts and lb.get("xty") == parts
          and lb.get("fused_apply_agg", 0) > 0
          and lb["fused_apply_agg"] % parts == 0,
          f"batch {tier}: launches {lb} for {parts} partitions")
    check(bd["partition_steps"] == 4 * parts,
          f"batch {tier}: {bd['partition_steps']} steps for 4 members of "
          f"{parts} partitions")
    # Batching changes nothing but a member's partitioning: bit for bit
    # against its serial run where the member's own partition rows are the
    # group's, and where they are not, against its request run alone at
    # the group's rows (the float32 partials of a zero-mean column sum fold
    # in another order at other rows: ``max_rel_diff`` is printed).
    for name in cmp["rows_equal"]:
        check(name in cmp["bit_for_bit"], f"batch {tier}: {name} differs "
              "from its serial run at equal partition rows")
    for name, same in cmp["bit_for_bit_alone_at_group_rows"]:
        check(same, f"batch {tier}: {name} differs from its request run "
              "alone at the group's partition rows")
    check(len(cmp["rows_equal"]) + len(cmp["bit_for_bit_alone_at_group_rows"])
          == len(BATCH_OUTPUTS), f"batch {tier}: an output went unchecked")


def inspect_batches(torch, XH, YH):
    """Three batches of the dense requests over the host copy inside
    ``fm.inspect_iterations()``: each batch after the first starts from the
    previous one's resident final partition, one reuse hit a staged source
    (X and y)."""
    from repro_torch.core import fm
    st0 = fm.exec_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fm.inspect_iterations():
        for _ in range(3):
            fm.batch(*dense_requests(fm, XH, YH), mode="ooc")
    torch.cuda.synchronize()
    st = fm.exec_stats()
    return {"phase": "main", "path": "batch", "tier": "host",
            "run": "inspect_iterations", "batches": 3, "sources": 2,
            "wall_ms": (time.perf_counter() - t0) * 1e3,
            "streams": st["streams"] - st0["streams"],
            "prefetch_reuse_hits": st["prefetch_reuse_hits"]
            - st0["prefetch_reuse_hits"]}


def batch_dense_phase(torch, x, y, XH, YH, XD, YD):
    """Path g, dense (inside path f, while X and y live on the device, in
    host RAM and on disk): the four requests on cuda over four tiers —
    device ``whole``, device ``stream``, host ``ooc`` and disk ``ooc``
    (warm) — serially and batched (``batch_tier``); three batches under
    ``fm.inspect_iterations()``; and ``fm.explain_batch`` of the requests.
    Counted.  Returns the launches and, per tier, the batch's results and
    its batched and serial wall ms (path h holds its windows to them)."""
    from repro_torch.core import fm
    from repro_torch.core.fusion import Plan
    from repro_torch.observability.explain import _fmt_bytes
    t_path = time.perf_counter()
    X, Y = fm.conv_R2FM(x), fm.conv_R2FM(y)
    tiers = (("device whole", X, Y, "whole"), ("device stream", X, Y,
                                               "stream"),
             ("host", XH, YH, "ooc"), ("disk warm", XD, YD, "ooc"))

    def run():
        with fm.conf(backend="cuda"):
            out = [batch_tier(torch, *t) for t in tiers]
            return out, inspect_batches(torch, XH, YH)

    fm.reset_exec_stats()
    (out, insp), launches = counted(torch, "batch dense",
                                    ("gram", "xty", "fused_apply_agg"), run)
    for lines, cmp, _ in out:
        for line in lines:
            emit(line)
        emit(cmp)
    emit(insp)
    text = fm.explain_batch(*dense_requests(fm, XH, YH))
    union = XH.m.nbytes() + YH.m.nbytes()
    serial = sum(Plan([o.m for o in outs_of(r)]).bytes_in()
                 for r in dense_requests(fm, XH, YH))
    emit({"phase": "explain_batch", "tier": "host", "text": text})
    emit({"phase": "batch", "half": "dense", "launches": launches,
          "seconds": time.perf_counter() - t_path})
    for (tier, Xt, Yt, mode), (_, cmp, detail) in zip(tiers, out):
        check_batch_tier(tier, Xt, Yt, mode, cmp, detail)
    check(insp["prefetch_reuse_hits"] == 2 * 2 and insp["streams"] == 3,
          f"inspect_iterations: {insp}")
    check("members=4" in text and "rounds=1" in text and union < serial
          and f"reads {_fmt_bytes(union)} once (vs {_fmt_bytes(serial)} "
          "serially)" in text, f"explain_batch: {text}")
    return launches, {
        tier: {"vals": detail[0], "batched_ms": detail[2]["wall_ms"],
               "serial_ms": detail[3]["wall_ms"]}
        for (tier, _, _, _), (_, _, detail) in zip(tiers, out)}


def batch_sparse_phase(torch, XH, y, gd):
    """Path g, sparse (inside path c, while the host slab lives):
    ``crossprod(Xs)`` and ``crossprod(Xs, y)`` ``ooc`` from host RAM
    through the prefetcher, as two solo materializes and as one
    ``fm.batch``, each once warm and then measured: one stream against
    two, ``spmm_gram`` and ``spmm_xty`` once a partition of the group, the
    Gram equal to whole mode's ``gd`` bit for bit and XᵀY to the serial
    run's.  Counted."""
    from repro_torch.core import fm
    t_path = time.perf_counter()
    YH = fm.conv_R2FM(y.reshape(-1, 1).cpu().numpy(), host=True)

    def make():
        return [fm.crossprod(XH), fm.crossprod(XH, YH)]

    def run():
        with fm.conf(backend="cuda"):
            grows, mrows = group_rows(make())
            runs = {}
            for name, fn in (("serial", run_serial),
                             ("batched", run_batched)):
                fn(fm, make, "ooc")                             # warm
                runs[name] = measure(torch, lambda: fn(fm, make, "ooc"))
            return grows, mrows, runs

    fm.reset_exec_stats()
    (grows, mrows, runs), launches = counted(
        torch, "batch sparse", ("spmm_gram", "spmm_xty"), run)
    (bvals, bd), (svals, sd) = runs["batched"], runs["serial"]
    for name in runs:
        emit({"phase": "main", "path": "batch", "tier": "sparse host",
              "mode": "ooc", "run": name, "group_rows": grows,
              "member_rows": mrows, **runs[name][1]})
    parts = -(-XH.nrow // grows)
    same = {"gram_whole": bool(torch.equal(bvals[0], gd)),
            "xty_serial": bool(torch.equal(bvals[1], svals[1]))}
    emit({"phase": "compare", "path": "batch", "tier": "sparse host",
          "speedup": sd["wall_ms"] / bd["wall_ms"], "bit_for_bit": same,
          "max_rel_diff": {"crossprod_xy": max_rel_diff(bvals[1], svals[1])},
          "launches": launches, "seconds": time.perf_counter() - t_path})
    check(bd["streams"] == 1 and sd["streams"] == 2
          and bd["passes"] == sd["passes"] == 2,
          f"sparse batch: {bd['streams']} / {sd['streams']} streams")
    check(bd["launches"].get("spmm_gram") == bd["launches"].get("spmm_xty")
          == parts > 1, f"sparse batch: launches {bd['launches']} for "
          f"{parts} partitions")
    check(all(same.values()), f"sparse batch: bit for bit {same}")
    return launches


# ---------------------------------------------------------------------------
# Path h: fm.serve — concurrent tenants through the admission-window Engine
# ---------------------------------------------------------------------------

def two_group_requests(fm, X, K):
    """Path h's two-group traffic (h3, h4): colMeans and crossprod over X
    and over the blobs."""
    return [fm.colMeans(X), fm.crossprod(X), fm.colMeans(K), fm.crossprod(K)]


def tenants(fm, eng, requests):
    """Each request submitted from its own tenant thread — released by a
    barrier, under its own ``fm.collect_stats()`` scope — into ``eng``;
    every result read back.  Returns the results flattened (physical
    matrices) and each tenant's scope stats; a tenant's exception is
    raised here."""
    barrier = threading.Barrier(len(requests))
    res = [None] * len(requests)
    stats = [None] * len(requests)
    errors = []

    def tenant(i, outs):
        try:
            with fm.collect_stats(f"tenant{i}") as sc:
                barrier.wait(timeout=60)
                r = eng.submit(*outs).result(timeout=600)
            res[i] = r if isinstance(r, list) else [r]
            stats[i] = sc.stats()
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    threads = [threading.Thread(target=tenant, args=(i, outs_of(req)))
               for i, req in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    check(not any(t.is_alive() for t in threads), "a tenant never finished")
    return [v for r in res for v in r], stats


def served(torch, eng, make):
    """One window of ``make()``'s requests from tenant threads, once warm
    and then measured (``measure``: wall ms until every result is read
    back and the card is idle, and the counters it moved).  Returns the
    measured run's results, counters and tenant stats."""
    from repro_torch.core import fm
    tenants(fm, eng, make())                                 # warm
    got = {}

    def run():
        vals, got["stats"] = tenants(fm, eng, make())
        return vals, list(fm.exec_stats()["pass_bytes_in"])

    vals, d = measure(torch, run)
    return vals, d, got["stats"]


def serve_counters():
    from repro_torch.observability import metrics
    return {k: metrics.root_counter(k) for k in
            ("serve_deferrals", "serve_admission_wait_seconds",
             "midstream_admits", "bytes_streamed")}


def alone_at(fm, outs, rows):
    """``outs`` materialized ``ooc`` alone at ``rows`` partition rows (its
    I/O budget scaled): what a group member computes, with the
    partitioning held equal."""
    from repro_torch.core.fusion import Plan
    own = Plan([o.m for o in outs]).passes[0].partition_rows
    budget = fm.set_conf()["io_partition_bytes"]
    with fm.conf(io_partition_bytes=budget * rows // own):
        check(Plan([o.m for o in outs]).passes[0].partition_rows == rows,
              f"alone at {rows} rows")
        return [fm._fm(v).logical_data()
                for v in fm.materialize(*outs, mode="ooc")]


@contextlib.contextmanager
def pinned_peak():
    """The peak, sampled every 2 ms, of the pinned host bytes the live
    prefetchers' slot rings hold."""
    from repro_torch.storage import prefetch
    peak = {"bytes": 0}
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            total = sum(b.numel() * b.element_size()
                        for p in list(prefetch._LIVE)
                        for slot in list(p._slots)
                        for b in list(slot.bufs.values()))
            peak["bytes"] = max(peak["bytes"], total)
            stop.wait(0.002)

    t = threading.Thread(target=sample, name="pinned-peak", daemon=True)
    t.start()
    try:
        yield peak
    finally:
        stop.set()
        t.join(timeout=10)


def serve_h1(torch, XH, YH, XD, YD, gres):
    """h1, window coalescing: path g's four requests from four tenant
    threads into one window (``max_window_requests=4``, no mid-stream
    admission), ``ooc`` from host RAM and from disk (warm)."""
    from repro_torch.core import fm
    from repro_torch.core.fusion import Plan
    lines, checks = [], []
    for tier, X, Y in (("host", XH, YH), ("disk warm", XD, YD)):
        grows, _ = group_rows(dense_requests(fm, X, Y))
        parts = -(-X.nrow // grows)
        own = [Plan([o.m for o in outs_of(r)]).bytes_in()
               for r in dense_requests(fm, X, Y)]
        with fm.serve(window_ms=60_000, max_window_requests=4, mode="ooc",
                      midstream_admission=False) as eng:
            vals, d, stats = served(torch, eng,
                                    lambda: dense_requests(fm, X, Y))
        g = gres[tier]
        same = [n for n, a, b in zip(BATCH_OUTPUTS, vals, g["vals"])
                if torch.equal(a, b)]
        line = {"phase": "main", "path": "serve", "arm": "h1", "tier": tier,
                "mode": "ooc", "group_rows": grows, "partitions": parts,
                **d, "batch_ms": g["batched_ms"],
                "serial_ms": g["serial_ms"],
                "tenants": [{k: st.get(k) for k in
                             ("streams", "passes", "bytes_streamed")}
                            for st in stats],
                "bit_for_bit_with_batch": same}
        lines.append(line)
        nbytes = X.m.nbytes() + Y.m.nbytes()
        lb = d["launches"]
        checks += [
            (d["streams"] == 1 and d["passes"] == 4,
             f"h1 {tier}: {d['streams']} streams, {d['passes']} passes"),
            (d["pass_bytes_in"] == [nbytes] and d["stage_bytes_read"]
             == nbytes, f"h1 {tier}: pass_bytes_in {d['pass_bytes_in']}, "
             f"read {d['stage_bytes_read']}, X and y {nbytes}"),
            (all(st["streams"] == 1 and st["bytes_streamed"] == b
                 for st, b in zip(stats, own)),
             f"h1 {tier}: tenant scopes {stats} against own bytes {own}"),
            (lb.get("gram") == parts and lb.get("xty") == parts
             and lb.get("fused_apply_agg") == 2 * parts,
             f"h1 {tier}: launches {lb} for {parts} partitions"),
            (same == list(BATCH_OUTPUTS), f"h1 {tier}: only {same} equal "
             "path g's batch bit for bit")]
    return lines, checks


def paced_matrix(XH, started, release):
    """X's host copy behind a store that holds the sweep at its second
    partition read until ``release``."""
    from repro_torch.core.matrix import DenseStore, FMMatrix

    class Paced(DenseStore):
        reads = 0

        def block(self, start, stop):
            self.reads += 1
            if self.reads == 2:
                started.set()
                release.wait(timeout=120)
            return super().block(start, stop)

    arr = XH.m.store.data
    return FMMatrix(arr.shape, arr.dtype, store=Paced(arr), name="paced")


def serve_h2(torch, x, XH):
    """h2, one mid-stream join: ``colSums(X)`` streams ``ooc`` from the
    host copy through a paced store; a late ``colMeans(X)`` is offered to
    the live gate while the sweep waits on its second partition, then the
    sweep goes on.  Prefetcher on and off, each once warm and then
    measured (traced: the ``catch_up`` span names the prefix)."""
    from repro_torch.core import fm
    n = x.shape[0]
    s64 = torch.zeros(N_COLS, dtype=torch.float64, device=x.device)
    a64 = torch.zeros_like(s64)
    for s, e in row_chunks(n):
        xc = x[s:e].double()
        s64 += xc.sum(0)
        a64 += xc.abs().sum(0)
    (solo,) = fm.materialize(fm.colMeans(XH), mode="ooc")
    solo = fm._fm(solo).logical_data()
    lines, checks = [], []
    for prefetch in (True, False):
        for run in ("warm", "measured"):
            started, release = threading.Event(), threading.Event()
            X = paced_matrix(XH, started, release)
            st0, c0 = fm.exec_stats(), serve_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with fm.trace(), fm.serve(window_ms=1, mode="ooc",
                                      prefetch=prefetch) as eng:
                h1 = eng.submit(fm.colSums(X))
                check(started.wait(timeout=120), "h2: the sweep never "
                      "started")
                # The prefetcher reads partition 1 (and so sets ``started``)
                # while the group may not yet have taken partition 0: the
                # late request joins mid-stream only once partition 0's
                # step has run, its admission point passed.
                deadline = time.time() + 120
                while (fm.exec_stats()["partition_steps"]
                       == st0["partition_steps"] and time.time() < deadline):
                    time.sleep(0.001)
                h2 = eng.submit(fm.colMeans(X))
                with eng._cv:
                    parked = not eng._pending
                release.set()
                sums, means = (fm._fm(h.result(timeout=600)).logical_data()
                               .reshape(-1) for h in (h1, h2))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                upto = [e["args"]["upto"] for e in fm.trace_events()
                        if e["name"] == "catch_up"]
                rows = [e["args"]["rows"] for e in fm.trace_events()
                        if e["name"] == "stream"]
            st, c1 = fm.exec_stats(), serve_counters()
            if run == "warm":
                continue
            missed = upto[0] if upto else 0
            catch_up_bytes = c1["bytes_streamed"] - c0["bytes_streamed"] \
                - X.nbytes()
            err_sums = float(((sums.double() - s64).abs() / a64).max())
            err_means = float(((means.double() - s64 / n).abs()
                               / (a64 / n)).max())
            rel_solo = max_rel_diff(means, solo.reshape(-1))
            norm_solo = max_norm_diff(means, solo.reshape(-1))
            d = {k: st[k] - st0[k] for k in
                 ("midstream_admits", "streams", "passes",
                  "partition_steps")}
            lines.append({
                "phase": "main", "path": "serve", "arm": "h2",
                "prefetch": prefetch, "wall_ms": wall * 1e3, **d,
                "parked_in_gate": parked, "group_rows": rows,
                "joined_at_row": missed, "catch_up_bytes": catch_up_bytes,
                "err_f64_sums": err_sums, "err_f64_means": err_means,
                "limit_f64": F64_TOL, "max_rel_diff_late_vs_solo": rel_solo,
                "max_norm_diff_late_vs_solo": norm_solo,
                "limit_late_vs_solo": SOLO_NORM_TOL,
                "late_bit_for_bit_with_solo": bool(torch.equal(
                    means, solo.reshape(-1)))})
            checks += [
                (parked and d["midstream_admits"] == 1 and d["streams"] == 1
                 and d["passes"] == 2, f"h2 prefetch={prefetch}: {d}, "
                 f"parked {parked}"),
                (missed > 0 and catch_up_bytes == missed * N_COLS * 4,
                 f"h2 prefetch={prefetch}: catch-up {catch_up_bytes} bytes "
                 f"for a prefix of {missed} rows"),
                (err_sums <= F64_TOL and err_means <= F64_TOL,
                 f"h2 prefetch={prefetch}: against float64 {err_sums}, "
                 f"{err_means} > {F64_TOL}"),
                (norm_solo <= SOLO_NORM_TOL, f"h2 prefetch={prefetch}: the "
                 f"late colMeans {norm_solo} from its solo run")]
    return lines, checks


def serve_h3_h4(torch, XH, XKH):
    """h3, two groups at once: colMeans and crossprod over X and over the
    blobs in one window — two disjoint source sets, two groups — with
    ``max_concurrent_streams=2`` and then 1, each once warm and then
    measured, with no in-flight-bytes cap (the 'auto' cap, a quarter
    second of the measured staging rate, would hold the second group back
    as h4 does); every result against its request run alone at the
    group's rows, the launches against the two groups' ``fm.batch`` runs.
    h4, the bandwidth cap: ``max_inflight_bytes`` one group's union bytes
    over the same traffic."""
    from repro_torch.core import fm
    reqs = two_group_requests(fm, XH, XKH)
    grows = [group_rows(reqs[i:i + 2])[0] for i in (0, 2)]
    alone = [v for i, req in enumerate(reqs)
             for v in alone_at(fm, outs_of(req), grows[i // 2])]
    expect = {}
    for i, X in enumerate((XH, XKH)):
        fm.batch(fm.colMeans(X), fm.crossprod(X), mode="ooc")     # warm
        _, bd = measure(torch, lambda: run_batched(
            fm, lambda: [fm.colMeans(X), fm.crossprod(X)], "ooc"))
        for k, v in bd["launches"].items():
            expect[k] = expect.get(k, 0) + v
    lines, checks, vals = [], [], {}
    for streams in (2, 1):
        c0 = serve_counters()
        with fm.serve(window_ms=60_000, max_window_requests=4, mode="ooc",
                      max_concurrent_streams=streams,
                      max_inflight_bytes=None,
                      midstream_admission=False) as eng:
            with pinned_peak() as peak:
                vals[streams], d, _ = served(
                    torch, eng, lambda: two_group_requests(fm, XH, XKH))
        deferrals = serve_counters()["serve_deferrals"] \
            - c0["serve_deferrals"]
        same = [torch.equal(a, b) for a, b in zip(vals[streams], alone)]
        lines.append({"phase": "main", "path": "serve", "arm": "h3",
                      "max_concurrent_streams": streams,
                      "group_rows": grows, **d,
                      "serve_deferrals": deferrals,
                      "pinned_peak_bytes": peak["bytes"],
                      "expected_launches": expect,
                      "bit_for_bit_alone_at_group_rows": same})
        checks += [
            (d["streams"] == 2 and d["passes"] == 4 and deferrals == 0,
             f"h3 streams={streams}: {d['streams']} streams, {deferrals} "
             "deferrals"),
            (d["launches"] == expect, f"h3 streams={streams}: launches "
             f"{d['launches']} against the groups' {expect}"),
            (all(same), f"h3 streams={streams}: bit for bit alone {same}")]
    cap = XH.m.nbytes()
    c0 = serve_counters()
    with fm.serve(window_ms=60_000, max_window_requests=4, mode="ooc",
                  max_concurrent_streams=2, max_inflight_bytes=cap,
                  midstream_admission=False) as eng:
        capped, d, _ = served(torch, eng,
                              lambda: two_group_requests(fm, XH, XKH))
    c1 = serve_counters()
    deferrals = c1["serve_deferrals"] - c0["serve_deferrals"]
    same = [torch.equal(a, b) for a, b in zip(capped, vals[2])]
    lines.append({"phase": "main", "path": "serve", "arm": "h4",
                  "max_inflight_bytes": cap, **d,
                  "windows": 2, "serve_deferrals": deferrals,
                  "serve_admission_wait_seconds":
                  c1["serve_admission_wait_seconds"]
                  - c0["serve_admission_wait_seconds"],
                  "bit_for_bit_with_h3": same})
    checks += [(deferrals >= 1 and d["streams"] == 2,
                f"h4: {deferrals} deferrals, {d['streams']} streams"),
               (all(same), f"h4: results against h3's {same}")]
    return lines, checks


def serve_h5():
    """h5, the load generator in process: ``repro_torch.launch.serve`` at
    Friendster-32's width over LOADGEN_ROWS rows, 4 clients, 3 waves."""
    from repro_torch.launch import serve as loadgen
    k, waves = 4, 3
    serial, srv = loadgen.main([
        "--n", str(LOADGEN_ROWS), "--p", str(N_COLS), "--clients", str(k),
        "--waves", str(waves), "--partition-kib", "65536"])
    line = {"phase": "main", "path": "serve", "arm": "h5",
            "rows": LOADGEN_ROWS, "cols": N_COLS,
            "rows_cut": "the generator draws its matrix with numpy on the "
                        "host; all 65,608,366 rows would take 20-40 s",
            "rows_bench": [{key: r[key] for key in
                            ("arm", "rps", "us_p50", "us_p99", "streams",
                             "bytes_per_request", "backend")}
                           for r in (serial, srv)]}
    checks = [(srv["streams"] == waves and serial["streams"] == k * waves,
               f"h5: streams serve {srv['streams']}, serial "
               f"{serial['streams']}"),
              (srv["bytes_per_request"] * k == serial["bytes_per_request"],
               f"h5: bytes a request {srv['bytes_per_request']} against "
               f"{serial['bytes_per_request']}")]
    return [line], checks


def serve_phase(torch, x, XH, YH, XKH, XD, YD, gres):
    """Path h, ``fm.serve`` (inside path f, after path g): h1 window
    coalescing, h2 a mid-stream join, h3 two groups at once, h4 the
    bandwidth cap, h5 the load generator; on cuda, counted.  Lines are
    printed before their checks are applied."""
    from repro_torch.core import fm
    t_path = time.perf_counter()

    def run():
        with fm.conf(backend="cuda"):
            out = [serve_h1(torch, XH, YH, XD, YD, gres),
                   serve_h2(torch, x, XH),
                   serve_h3_h4(torch, XH, XKH)]
        out.append(serve_h5())
        return out

    fm.reset_exec_stats()
    out, launches = counted(torch, "serve", ("gram", "xty",
                                             "fused_apply_agg"), run)
    for lines, _ in out:
        for line in lines:
            emit(line)
    emit({"phase": "serve", "launches": launches,
          "seconds": time.perf_counter() - t_path})
    for _, checks in out:
        for ok, what in checks:
            check(ok, what)
    return launches


# ---------------------------------------------------------------------------
# Path i: sharded execution over [cuda:0] × k
# ---------------------------------------------------------------------------

def card_mesh(torch, k):
    """``k`` shards on this one card (axis ``data``): each shard drives its
    own executor on a thread and a CUDA stream of its own."""
    from repro_torch.launch.mesh import Mesh
    return Mesh([torch.device(DEVICE, 0)] * k, ("data",))


def shard_calls(fm, X, Y):
    """Path i1's calls, each in ``stream`` mode over the device X."""
    from repro_torch.algorithms import correlation, glm, kmeans, summary
    return (
        ("correlation", lambda: correlation(X, mode="stream")),
        ("summary", lambda: summary(X, mode="stream")),
        ("glm", lambda: glm(X, Y, family="logistic", max_iter=3,
                            mode="stream")),
        ("kmeans", lambda: kmeans(X, k=K_CLUSTERS, max_iter=2,
                                  mode="stream")),
        ("crossprod", lambda: fm.materialize(fm.crossprod(X),
                                             mode="stream")[0]))


SHARD_STATS = ("shards", "shard_merges", "passes", "partition_steps",
               "materialize_calls", "streams", "midstream_admits")


def shard_run(torch, calls):
    """Each ``(name, fn)`` of ``calls`` once, untraced: its result, wall ms
    (host clock around a call that ends in a synchronize), the counters it
    moved (``SHARD_STATS``, each kernel's launches) and the last pass's
    ``shard_bytes_in`` and ``pass_bytes_in``."""
    from repro_torch.core import fm
    out, info = {}, {}
    for name, fn in calls:
        st0 = fm.exec_stats()
        torch.cuda.synchronize()
        k0 = read_counts()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = read_counts()
        st = fm.exec_stats()
        info[name] = {"wall_ms": wall * 1e3,
                      **{k: st[k] - st0[k] for k in SHARD_STATS},
                      "launches": {k: k1[k] - k0[k] for k in k1
                                   if k1[k] != k0[k]},
                      "shard_bytes_in": list(st["shard_bytes_in"]),
                      "pass_bytes_in": list(st["pass_bytes_in"])}
    return out, info


def shard_stream_arm(torch, x, y, g64):
    """i1: path i1's calls in ``stream`` mode unsharded, then under
    ``[cuda:0] × 1, × 2`` twice each (the first run builds the
    mesh's plans; the lines are the second's).  Checked: k shards and
    k − 1 merges a pass, ``shard_bytes_in`` k entries summing to the last
    pass's bytes, the unsharded run's passes, steps and launches; k = 1
    bit for bit with unsharded, each k bit for bit run to run; the Gram
    within ``F64_TOL`` / ``F64_TOL_OFFDIAG`` of float64."""
    from repro_torch.core import fm
    X, Y = fm.conv_R2FM(x), fm.conv_R2FM(y)
    calls = shard_calls(fm, X, Y)
    names = [n for n, _ in calls]
    shard_run(torch, calls)                           # warm: plans, kernels
    with fm.conf(mesh=False):
        base, binfo = shard_run(torch, calls)
    lines, checks = [], []
    for k in (1, 2):
        with fm.conf(mesh=card_mesh(torch, k)):
            runs = [shard_run(torch, calls) for _ in range(2)]
        (res, _), (res2, info) = runs
        diffs_k = same_results(res, res2, names)
        diffs_base = same_results(base, res, names)
        de, do = corr_err(torch, fm._fm(res["crossprod"]).logical_data(),
                          g64)
        for name in names:
            d, b = info[name], binfo[name]
            lines.append({"phase": "main", "path": "shard", "arm": "i1",
                          "mode": "stream", "shards_k": k, "call": name,
                          **d, "unsharded_ms": b["wall_ms"],
                          "ratio": d["wall_ms"] / b["wall_ms"]})
            checks += [
                (d["shards"] == k * d["passes"]
                 and d["shard_merges"] == (k - 1) * d["passes"],
                 f"i1 k={k} {name}: {d['shards']} shards, "
                 f"{d['shard_merges']} merges for {d['passes']} passes"),
                (len(d["shard_bytes_in"]) == k
                 and sum(d["shard_bytes_in"]) == d["pass_bytes_in"][-1],
                 f"i1 k={k} {name}: shard_bytes_in {d['shard_bytes_in']} "
                 f"against the pass's {d['pass_bytes_in']}"),
                (all(d[s] == b[s] for s in ("passes", "partition_steps",
                                             "materialize_calls"))
                 and d["launches"] == b["launches"],
                 f"i1 k={k} {name}: {d} against unsharded {b}")]
        lines.append({"phase": "compare", "path": "shard", "arm": "i1",
                      "shards_k": k, "differs_run_to_run": diffs_k,
                      "differs_from_unsharded": diffs_base,
                      "gram_err_f64": [de, do]})
        checks += [(not diffs_k, f"i1 k={k}: runs differ in {diffs_k}"),
                   (k > 1 or not diffs_base,
                    f"i1 k=1 differs from unsharded in {diffs_base}"),
                   (de <= F64_TOL and do <= F64_TOL_OFFDIAG,
                    f"i1 k={k}: Gram err {de}, {do} against float64")]
    return lines, checks


def colsum_err(torch, s, x):
    """A float32 column-sum vector against float64, in units of Σ|x|."""
    s1 = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    a1 = torch.zeros_like(s1)
    for a, b in row_chunks(x.shape[0]):
        xc = x[a:b].double()
        s1 += xc.sum(0)
        a1 += xc.abs().sum(0)
    return float(((s.double().reshape(-1) - s1).abs() / a1).max())


def shard_whole_arm(torch, x, g64):
    """i2: ``materialize(crossprod(X), colSums(X), mesh=)`` in whole mode:
    at k = 2 the rows divide and split in two blocks, at k = 4 they do not
    and the group runs unsplit (bit for bit with whole mode), shards 1."""
    from repro_torch.core import fm
    X = fm.conv_R2FM(x)
    want = [fm._fm(v).logical_data() for v in
            fm.materialize(fm.crossprod(X), fm.colSums(X))]
    lines, checks = [], []
    for k in (2, 4):
        mesh = card_mesh(torch, k)
        calls = (("whole", lambda: fm.materialize(
            fm.crossprod(X), fm.colSums(X), mesh=mesh)),)
        shard_run(torch, calls)                                  # warm
        res, info = shard_run(torch, calls)
        d = info["whole"]
        g, s = (fm._fm(v).logical_data() for v in res["whole"])
        de, do = corr_err(torch, g, g64)
        se = colsum_err(torch, s, x)
        same = torch.equal(g, want[0]) and torch.equal(s, want[1])
        split = N_ROWS % k == 0
        d.pop("shard_bytes_in")  # a streamed pass's, not this call's
        lines.append({"phase": "main", "path": "shard", "arm": "i2",
                      "mode": "whole", "shards_k": k, **d,
                      "rows_divide": split, "bit_for_bit_with_whole": same,
                      "gram_err_f64": [de, do], "colsums_err_f64": se})
        checks += [
            (d["shards"] == (k if split else 1),
             f"i2 k={k}: {d['shards']} shards, rows divide: {split}"),
            (d["shard_merges"] == 0 and d["streams"] == 1
             and d["partition_steps"] == 1,
             f"i2 k={k}: {d}"),
            (d["launches"].get("gram") == (k if split else 1),
             f"i2 k={k}: gram launches {d['launches']}"),
            (split or same, f"i2 k={k}: the unsplit run differs from whole "
             "mode"),
            (de <= F64_TOL and do <= F64_TOL_OFFDIAG and se <= F64_TOL,
             f"i2 k={k}: Gram err {de}, {do}, colSums err {se}")]
    return lines, checks


def shard_batch_arm(torch, x, y, XH, YH, g64, gres):
    """i3: path g's four requests as one ``fm.batch(mesh=[cuda:0] × 2)``
    ``ooc`` from the host copies through two prefetchers: one stream, two
    shards, X and y read once; the Gram and XᵀY within float64's limits,
    every output's difference from path g's batch printed and held to
    ``SOLO_NORM_TOL``; the pinned peak printed."""
    from repro_torch.core import fm
    mesh = card_mesh(torch, 2)

    def run():
        vals = []
        for r in fm.batch(*dense_requests(fm, XH, YH), mode="ooc",
                          mesh=mesh):
            vals += r if isinstance(r, list) else [r]
        return vals, list(fm.exec_stats()["pass_bytes_in"])

    run()                                                        # warm
    st0 = fm.exec_stats()
    with pinned_peak() as peak:
        vals, d = measure(torch, run)
    st = fm.exec_stats()
    d.update({k: st[k] - st0[k] for k in ("shards", "shard_merges")})
    d["shard_bytes_in"] = list(st["shard_bytes_in"])
    g = gres["host"]
    named = dict(zip(BATCH_OUTPUTS, vals))
    de, do = corr_err(torch, named["crossprod"], g64)
    xy64, units = xty64(torch, x, y.reshape(-1, 1))
    xe = float(((named["crossprod_xy"].double() - xy64).abs() / units).max())
    norm = {n: max_norm_diff(a, b)
            for n, a, b in zip(BATCH_OUTPUTS, vals, g["vals"])}
    nbytes = XH.m.nbytes() + YH.m.nbytes()
    line = {"phase": "main", "path": "shard", "arm": "i3", "mode": "ooc",
            "shards_k": 2, **d, "pinned_peak_bytes": peak["bytes"],
            "batch_ms": g["batched_ms"], "serial_ms": g["serial_ms"],
            "gram_err_f64": [de, do], "xty_err_f64": xe,
            "max_norm_diff_from_batch": norm}
    checks = [
        (d["streams"] == 1 and d["passes"] == 4 and d["shards"] == 2
         and d["shard_merges"] == 4, f"i3: {d}"),
        (d["stage_bytes_read"] == nbytes and d["pass_bytes_in"] == [nbytes],
         f"i3: read {d['stage_bytes_read']}, X and y {nbytes}"),
        (de <= F64_TOL and do <= F64_TOL_OFFDIAG and xe <= F64_TOL,
         f"i3: Gram err {de}, {do}, XᵀY err {xe} against float64"),
        (max(norm.values()) <= SOLO_NORM_TOL,
         f"i3: differs from path g's batch by {norm}")]
    return [line], checks


def shard_spill_arm(torch, x):
    """i4: ``scale(D, save="disk")`` ``ooc`` under ``[cuda:0] × 2``, D the
    first SPILL_ROWS rows of X as an ``.fmat`` (a cut of depth): both
    shards' rows land in one spill file, its size and header checked, and
    4096 random rows against float64."""
    import numpy as np
    from repro_torch import storage
    from repro_torch.core import fm
    n = SPILL_ROWS
    D = fm.save_dense_matrix(x[:n], "shard_spill_x")
    st0 = fm.exec_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fm.conf(mesh=card_mesh(torch, 2)):
        (Z,) = fm.materialize(fm.scale(D, save="disk"), mode="ooc")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = fm.exec_stats()
    store = Z.m.store
    size = store.path.stat().st_size
    h = storage.read_header(store.path)
    xs = x[:n]
    s1 = torch.zeros(N_COLS, dtype=torch.float64, device=x.device)
    s2 = torch.zeros_like(s1)
    for a, b in row_chunks(n):
        xc = xs[a:b].double()
        s1 += xc.sum(0)
        s2 += (xc * xc).sum(0)
    mu = s1 / n
    sd = ((s2 - n * mu ** 2) / (n - 1)).sqrt()
    rows = np.sort(np.random.default_rng(SEED + 26).choice(n, 4096,
                                                           replace=False))
    want = ((xs[torch.as_tensor(rows, device=x.device)].double() - mu) / sd)
    got = torch.as_tensor(np.asarray(store.logical()[rows], np.float64),
                          device=x.device)
    row_err = float((got - want).abs().max())
    d = {"wall_ms": wall * 1e3, "rows": n,
         **{k: st[k] - st0[k] for k in SHARD_STATS},
         "shard_bytes_in": list(st["shard_bytes_in"]), "spill_bytes": size,
         "rows_checked": len(rows), "rows_max_abs_err_f64": row_err}
    line = {"phase": "main", "path": "shard", "arm": "i4", "mode": "ooc",
            "shards_k": 2, **d}
    checks = [
        (Z.m.on_disk and d["passes"] == 2 and d["shards"] == 4,
         f"i4: on disk {Z.m.on_disk}, {d}"),
        (size == h.body_offset + n * N_COLS * 4
         and (h.nrow, h.ncol, h.layout) == (n, N_COLS, "row")
         and h.dtype == np.float32, f"i4: spill file {size} bytes, {h}"),
        (row_err <= 1e-5, f"i4: rows against float64 {row_err}")]
    return [line], checks


def shard_serve_arm(torch, XH, g64):
    """i5: ``Engine(mesh=[cuda:0] × 2)``, two tenants — ``colMeans(X)`` and
    ``crossprod(X)`` from the host copy — in one window: sharded, no
    mid-stream admission, no gate; the Gram within float64's limits and
    colMeans within ``SOLO_NORM_TOL`` of the unsharded Engine's."""
    from repro_torch.core import fm

    def make():
        return [fm.colMeans(XH), fm.crossprod(XH)]

    got = {}
    for name, mesh in (("unsharded", None), ("sharded", card_mesh(torch, 2))):
        with fm.serve(window_ms=60_000, max_window_requests=2, mode="ooc",
                      mesh=mesh) as eng:
            tenants(fm, eng, make())                             # warm
            st0 = fm.exec_stats()
            vals, d = measure(torch, lambda: (
                tenants(fm, eng, make())[0],
                list(fm.exec_stats()["pass_bytes_in"])))
            st = fm.exec_stats()
            with eng._gates_lock:
                gates = len(eng._gates)
        d.update({k: st[k] - st0[k] for k in ("shards", "shard_merges",
                                               "midstream_admits")})
        got[name] = (vals, d, gates)
    (uv, ud, _), (sv, sd, gates) = got["unsharded"], got["sharded"]
    de, do = corr_err(torch, sv[1], g64)
    norm = max_norm_diff(sv[0], uv[0])
    line = {"phase": "main", "path": "shard", "arm": "i5", "mode": "ooc",
            "shards_k": 2, **sd, "unsharded_ms": ud["wall_ms"],
            "gates": gates, "gram_err_f64": [de, do],
            "colmeans_max_norm_diff": norm}
    checks = [
        (sd["shards"] > 0 and sd["midstream_admits"] == 0 and gates == 0,
         f"i5: {sd}, {gates} gates"),
        (de <= F64_TOL and do <= F64_TOL_OFFDIAG,
         f"i5: Gram err {de}, {do} against float64"),
        (norm <= SOLO_NORM_TOL, f"i5: colMeans differs by {norm}")]
    return [line], checks


def shard_fault_arm(torch, XH):
    """i7: a staging fault in one shard (a store that fails its fourth
    block read) under ``[cuda:0] × 2``: the materialize raises, nothing
    registers, and the prefetcher, staged and thread audits are empty."""
    import numpy as np
    from repro_torch import storage
    from repro_torch.core import fm
    from repro_torch.core.matrix import DenseStore, FMMatrix

    class FlakyStore(DenseStore):
        def __init__(self, data):
            super().__init__(data)
            self.reads, self.lock = 0, threading.Lock()

        def block(self, start, stop):
            with self.lock:
                self.reads += 1
                n = self.reads
            if n > 3:
                raise RuntimeError("injected shard staging failure")
            return super().block(start, stop)

    host = XH.m.logical_data()[:FAULT_ROWS]
    Xf = FMMatrix(host.shape, np.float32, store=FlakyStore(host),
                  name="flaky")
    G = fm.crossprod(fm.FM(Xf) * 2.0)
    raised = None
    try:
        fm.materialize(G, mode="ooc", prefetch=True,
                       mesh=card_mesh(torch, 2))
    except Exception as exc:  # noqa: BLE001 - checked below
        raised = repr(exc)
    deadline = time.time() + 10
    while time.time() < deadline and storage.live_prefetchers():
        time.sleep(0.05)
    shard_threads = [t.name for t in threading.enumerate()
                     if t.name.startswith("fm-shard")]
    line = {"phase": "stress", "path": "shard", "arm": "i7",
            "raised": raised, "registered": not G.m.is_virtual,
            "live_prefetchers": len(storage.live_prefetchers()),
            "staged_leaks": len(storage.staged_leaks()),
            "shard_threads": shard_threads}
    checks = [
        (raised is not None and "injected shard staging" in raised,
         f"i7: {raised}"),
        (G.m.is_virtual and getattr(G.m, "cached_store", None) is None,
         "i7: a partial sink registered"),
        (not line["live_prefetchers"] and not line["staged_leaks"]
         and not shard_threads, f"i7: {line}")]
    return [line], checks


def shard_dense_phase(torch, x, y, XH, YH, gres):
    """Path i, dense (inside path f, after path h, while X and y live on
    the device, in host RAM and on disk): i1 stream, i2 whole, i3 a host
    ``ooc`` batch, i4 a spill and i5 an Engine, all over ``[cuda:0] × k``,
    counted; then i7, an injected shard fault.  Each arm's lines are
    printed before its checks.  Returns the launches."""
    from repro_torch.core import fm
    t_path = time.perf_counter()
    g64 = gram64(torch, x)

    def run():
        with fm.conf(backend="cuda"):
            return [shard_stream_arm(torch, x, y, g64),
                    shard_whole_arm(torch, x, g64),
                    shard_batch_arm(torch, x, y, XH, YH, g64, gres),
                    shard_spill_arm(torch, x),
                    shard_serve_arm(torch, XH, g64)]

    fm.reset_exec_stats()
    arms, launches = counted(torch, "shard dense",
                             ("gram", "xty", "fused_apply_agg", "wgram",
                              "kmeans_assign"), run)
    with fm.conf(backend="cuda"):
        arms.append(shard_fault_arm(torch, XH))
    for lines, _ in arms:
        for line in lines:
            emit(line)
    emit({"phase": "shard", "half": "dense", "launches": launches,
          "seconds": time.perf_counter() - t_path})
    for _, checks in arms:
        for cond, what in checks:
            check(cond, what)
    return launches


def shard_sparse_arm(torch, Xs, XH, Xm, Ym, gd, gs, host_steps):
    """i6 (inside path c, while the device and host slabs live), under
    ``[cuda:0] × 2``: ``crossprod(Xs)`` in ``stream`` over the device slab
    and ``ooc`` from the host slab, and ``glm(max_iter=2)`` in ``stream``
    on the 2^22-row slab, with their unsharded twins: the SpMM kernels'
    launches as unsharded, 2 shards a pass, the Gram within
    SPARSE_SHARD_TOL (relative) of whole mode's and the log-likelihoods
    within 1e-4 of the unsharded fit's.  Counted; returns the launches."""
    import numpy as np
    from repro_torch.algorithms import glm
    from repro_torch.core import fm
    mesh = card_mesh(torch, 2)
    calls = (
        ("crossprod_stream", lambda: fm.materialize(fm.crossprod(Xs),
                                                    mode="stream")),
        ("glm_stream", lambda: glm(Xm, Ym, "logistic", ridge=1e-3,
                                   max_iter=2, mode="stream")),
        ("crossprod_ooc", lambda: fm.materialize(fm.crossprod(XH),
                                                 mode="ooc")))

    def run():
        with fm.conf(backend="cuda"):
            base = shard_run(torch, calls[:2])
            with fm.conf(mesh=mesh):
                return base, shard_run(torch, calls)

    t0 = time.perf_counter()
    fm.reset_exec_stats()
    ((bres, binfo), (res, info)), launches = counted(
        torch, "shard sparse", ("spmm_gram", "spmm_xty", "spmm_wgram"), run)
    rel = {n: float((fm._fm(res[n][0]).logical_data().double()
                     - gd.double()).abs().max() / gd.double().abs().max())
           for n in ("crossprod_stream", "crossprod_ooc")}
    g, gb = res["glm_stream"], bres["glm_stream"]
    ll = float(np.max(np.abs(np.array(g.loglik_trace)
                             - np.array(gb.loglik_trace))
                      / np.abs(np.array(gb.loglik_trace))))
    lines = [{"phase": "main", "path": "shard", "arm": "i6",
              "shards_k": 2, "call": n, **d,
              **({"unsharded_ms": binfo[n]["wall_ms"]} if n in binfo
                 else {})} for n, d in info.items()]
    lines.append({"phase": "compare", "path": "shard", "arm": "i6",
                  "gram_rel_diff_from_whole": rel,
                  "gram_tol": SPARSE_SHARD_TOL,
                  "glm_loglik_trace": [g.loglik_trace, gb.loglik_trace,
                                       gs.loglik_trace],
                  "glm_loglik_rel_diff": ll, "launches": launches,
                  "seconds": time.perf_counter() - t0})
    for line in lines:
        emit(line)
    for n, d in info.items():
        check(d["shards"] == 2 * d["passes"] and d["shard_merges"]
              == d["passes"], f"i6 {n}: {d}")
    for n in ("crossprod_stream", "crossprod_ooc"):
        d = info[n]
        check(d["launches"].get("spmm_gram") == d["partition_steps"]
              == host_steps, f"i6 {n}: spmm_gram {d['launches']} for "
              f"{d['partition_steps']} steps, unsharded {host_steps}")
        check(rel[n] <= SPARSE_SHARD_TOL, f"i6 {n}: Gram differs from "
              f"whole mode's by {rel[n]}")
    for n, b in binfo.items():
        d = info[n]
        check(d["launches"] == b["launches"] and d["partition_steps"]
              == b["partition_steps"], f"i6 {n}: {d} against unsharded {b}")
    check(ll <= 1e-4, f"i6 glm log-likelihoods differ by {ll}")
    return launches


def explain_phase(torch, x, y, xk):
    """``fm.explain(..., backend="cuda")`` of every materialize path a's
    four calls make (``fm.materialize`` wrapped while each call runs on
    cuda): each call's dispatch lines must name exactly the kernels that
    call launched."""
    import re
    from repro_torch.algorithms import correlation, glm, kmeans, summary
    from repro_torch.core import fm
    X, Y, XK = fm.conv_R2FM(x), fm.conv_R2FM(y), fm.conv_R2FM(xk)
    calls = (("summary", lambda: summary(X)),
             ("correlation", lambda: correlation(X)),
             ("glm", lambda: glm(X, Y, family="logistic", max_iter=8)),
             ("kmeans", lambda: kmeans(XK, k=K_CLUSTERS, max_iter=5)))
    real = fm.materialize
    texts = []

    def explaining(*xs, **kw):
        texts.append(fm.explain(*xs, backend="cuda"))
        return real(*xs, **kw)

    out = []
    with fm.conf(backend="cuda"):
        for name, fn in calls:
            texts.clear()
            torch.cuda.synchronize()
            k0 = read_counts()
            fm.materialize = explaining
            try:
                fn()
            finally:
                fm.materialize = real
            torch.cuda.synchronize()
            k1 = read_counts()
            launched = sorted(k for k in k1 if k1[k] > k0[k])
            dispatch = sorted({ln.strip() for t in texts
                               for ln in t.splitlines()
                               if ln.strip().startswith("->")})
            named = sorted({k for t in texts
                            for m in re.findall(r"cuda:([\w/]+)", t)
                            for k in m.split("/")})
            emit({"phase": "explain", "call": name, "materializes":
                  len(texts), "dispatch": dispatch, "named": named,
                  "launched": launched})
            out.append((name, named, launched))
    for name, named, launched in out:
        check(named == launched and launched, f"explain {name}: names "
              f"{named}, the call launched {launched}")


def flash_row(torch):
    """The flash kernel at the serving path's shape — B 4, 24 q heads over
    8 KV heads, S = T = 4096, head dim 128, bf16, causal — against its plain
    version (f32 math, a chunk of heads at a time) and float64 on a few
    heads, each within one bf16 rounding of the output, and in float32
    within 2e-3.

    The bf16 kernel computes in f32 and rounds once to bf16: at most half a
    bf16 ulp, 2^-8·|o|, off the f32 plain version's unrounded output.  It
    is held to 2e-3 + 1e-2·|o| of that (2.5 times the rounding, room for
    f32 sums in another order) and to 1e-5 + 2^-7·|o| of float64 (one ulp
    or more).  The JAX tests' atol = rtol = 3e-2 would pass nearly any
    output at this shape, where a typical |o| is about 0.03."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, flash_attention as fa, ref
    cfg = get_config(LM_ARCH)
    B, nh, nkv, S, d = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_PROMPT, cfg.hd
    g = nh // nkv
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 4)
    q = torch.randn((B, nh, S, d), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, nkv, S, d), generator=gen, device=DEVICE,
                        dtype=torch.bfloat16) for _ in range(2))
    o = fa.flash_attention(q, k, v, causal=True)
    qf, kf, vf = q.float(), k.float(), v.float()
    pf = ref.flash_attention_ref(qf, kf, vf, causal=True)   # f32, unrounded
    diff = (o.float() - pf).abs()
    excess = float((diff - 2e-3 - 1e-2 * pf.abs()).max())
    err64 = excess64 = -float("inf")
    for b, h in ((0, 0), (B // 2, g + 1), (B - 1, nh - 1)):
        o64 = ref.flash_attention_ref(qf[b:b + 1, h:h + 1].double(),
                                      kf[b:b + 1, h // g:h // g + 1].double(),
                                      vf[b:b + 1, h // g:h // g + 1].double(),
                                      causal=True, dtype=torch.float64)[0, 0]
        d64 = (o[b, h].double() - o64).abs()
        err64 = max(err64, float(d64.max()))
        excess64 = max(excess64,
                       float((d64 - 1e-5 - 2.0 ** -7 * o64.abs()).max()))
    of = fa.flash_attention(qf, kf, vf, causal=True)
    excess32 = float(((of - pf).abs() - 2e-3 - 2e-3 * pf.abs()).max())
    ops = 2 * B * nh * S * S * d                  # causal: half of 4·B·nh·S²·d
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())  # q, o, k, v once, bf16
    b = bound(nbytes, ops, BF16_FLOP_S)
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:101",
        shape=f"q ({B}, {nh}, {S}, {d}), k/v ({B}, {nkv}, {S}, {d}) bf16, "
              "causal",
        body=fa.body_for(q.dtype, d), f32_body=fa.body_for(qf.dtype, d),
        ptxas=build.ptxas_report("flash_attention",
                                 f"flash_fwd_wgmmaILi{d}ELb1E"),
        max_abs_err=float(diff.max()),
        tol="|o - plain| <= 2e-3 + 1e-2·|plain|, plain the f32 plain version",
        tol_excess=excess, max_abs_err_f64=err64,
        tol_f64="|o - o64| <= 1e-5 + 2^-7·|o64| (one bf16 ulp)",
        tol_f64_excess=excess64,
        f32_max_abs_err=float((of - pf).abs().max()),
        f32_tol="atol = rtol = 2e-3", f32_tol_excess=excess32,
        ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True)),
        f32_ms=time_ms(torch, lambda: fa.flash_attention(qf, kf, vf,
                                                         causal=True)),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal=True), reps=2),
        bound_ms=b[0], bound_by=b[1], bound_rate="bf16 tensor, 989 TFLOP/s",
        design_bound_ms=1.5 * ops / BF16_FLOP_S * 1e3,
        design_bound_note="the wgmma body's QKᵀ plus P·V as two products "
                          "(P split into bf16 hi + lo): 1.5× the operations",
        bound_f32_ms=ops / F32_FLOP_S * 1e3, ops=ops, bytes=nbytes,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        library="torch.nn.functional.scaled_dot_product_attention("
                "is_causal=True, enable_gqa=True)")
    row["d112"] = flash_d112(torch)
    emit({"phase": "kernel", **row})
    check(row["d112"]["tol_excess"] <= 0, "flash_attention at head dim 112 "
          "exceeds 2e-3 + 1e-2·|plain| of the f32 plain version by "
          f"{row['d112']['tol_excess']}")
    check(excess <= 0, f"flash_attention bf16 exceeds 2e-3 + 1e-2·|plain| "
          f"of the f32 plain version by {excess}")
    check(excess64 <= 0, f"flash_attention bf16 exceeds one bf16 ulp of "
          f"float64 by {excess64}")
    check(excess32 <= 0, f"flash_attention f32 exceeds atol = rtol = 2e-3 "
          f"of the plain version by {excess32}")
    del q, k, v, o, diff, qf, kf, vf, of, pf
    torch.cuda.empty_cache()
    return row


def flash_d112(torch):
    """Head dim 112 (zamba2-7b's attention: 32 heads, no GQA), bf16, causal,
    S = T = 4096 on the FMA body, against the f32 plain version under the
    serving row's rule; its time is printed, not checked."""
    from repro_torch.kernels import build, flash_attention as fa, ref
    B, nh, S, d = 1, 32, LM_PROMPT, 112
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 5)
    q, k, v = (torch.randn((B, nh, S, d), generator=gen, device=DEVICE,
                           dtype=torch.bfloat16) for _ in range(3))
    o = fa.flash_attention(q, k, v, causal=True)
    pf = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    diff = (o.float() - pf).abs()
    out = dict(shape=f"q, k, v ({B}, {nh}, {S}, {d}) bf16, causal",
               body=fa.body_for(q.dtype, d), max_abs_err=float(diff.max()),
               tol_excess=float((diff - 2e-3 - 1e-2 * pf.abs()).max()),
               ms=time_ms(torch, lambda: fa.flash_attention(q, k, v,
                                                            causal=True)),
               ptxas=build.ptxas_report("flash_attention",
                                        f"flash_fwdI13__nv_bfloat16Li{d}E"))
    del q, k, v, o, pf, diff
    return out


def flash_case(torch, B, nh, nkv, S, d, seed, T=None, causal=True):
    """The flash kernel at one serving shape — q (B, nh, S, d), k/v (B, nkv,
    T, d) (T = S by default), bf16, causal or not — under the serving row's
    rule: within 2e-3 + 1e-2·|plain| of its f32 plain version and within
    one bf16 ulp of float64 on three heads; its ms beside its plain
    version's, SDPA's (the same ``is_causal``) and the bound (at the bf16
    tensor rate, the inputs' type, and at the f32 rate, which bounds the
    FMA body) from 4·B·nh·S·T·d operations, half that causal."""
    import torch.nn.functional as F
    from repro_torch.kernels import build, flash_attention as fa, ref
    T = S if T is None else T
    g = nh // nkv
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    q = torch.randn((B, nh, S, d), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((B, nkv, T, d), generator=gen, device=DEVICE,
                        dtype=torch.bfloat16) for _ in range(2))
    o = fa.flash_attention(q, k, v, causal=causal)
    pf = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal)
    diff = (o.float() - pf).abs()
    excess = float((diff - 2e-3 - 1e-2 * pf.abs()).max())
    err64 = excess64 = -float("inf")
    for b, h in ((0, 0), (B // 2, min(g + 1, nh - 1)), (B - 1, nh - 1)):
        o64 = ref.flash_attention_ref(
            q[b:b + 1, h:h + 1].double(), k[b:b + 1, h // g:h // g + 1].double(),
            v[b:b + 1, h // g:h // g + 1].double(), causal=causal,
            dtype=torch.float64)[0, 0]
        d64 = (o[b, h].double() - o64).abs()
        err64 = max(err64, float(d64.max()))
        excess64 = max(excess64,
                       float((d64 - 1e-5 - 2.0 ** -7 * o64.abs()).max()))
    ops = 4 * B * nh * S * T * d // (2 if causal else 1)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())  # q, o, k, v once, bf16
    bt, bf = bound(nbytes, ops, BF16_FLOP_S), bound(nbytes, ops, F32_FLOP_S)
    body = fa.body_for(q.dtype, d)
    out = dict(
        name="flash_attention",
        shape=f"q ({B}, {nh}, {S}, {d}), k/v ({B}, {nkv}, {T}, {d}) bf16, "
              + ("causal" if causal else "not causal"), group=g, body=body,
        ptxas=build.ptxas_report(
            "flash_attention", f"flash_fwd_wgmmaILi{d}ELb1E"
            if body == "wgmma" else f"flash_fwdI13__nv_bfloat16Li{d}E"),
        max_abs_err=float(diff.max()),
        tol="|o - plain| <= 2e-3 + 1e-2·|plain|, plain the f32 plain version",
        tol_excess=excess, max_abs_err_f64=err64,
        tol_f64="|o - o64| <= 1e-5 + 2^-7·|o64| (one bf16 ulp)",
        tol_f64_excess=excess64,
        ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal)),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal=causal), reps=2),
        bound_ms=bt[0], bound_by=bt[1], bound_rate="bf16 tensor, 989 TFLOP/s",
        bound_f32_ms=bf[0], bound_f32_by=bf[1], ops=ops, bytes=nbytes,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)),
        library="torch.nn.functional.scaled_dot_product_attention("
                f"is_causal={causal}, enable_gqa=True)")
    del q, k, v, o, pf, diff
    torch.cuda.empty_cache()
    return out


def check_flash_case(path, row):
    check(row["tol_excess"] <= 0, f"{path}: flash_attention at "
          f"{row['shape']} exceeds 2e-3 + 1e-2·|plain| of the f32 plain "
          f"version by {row['tol_excess']}")
    check(row["tol_f64_excess"] <= 0, f"{path}: flash_attention at "
          f"{row['shape']} exceeds one bf16 ulp of float64 by "
          f"{row['tol_f64_excess']}")


def serve_init(torch, arch):
    """The serving model of ``arch`` at its published width and depth, bf16
    weights drawn on the card from seed ``SEED``: (cfg, model, params, the
    generator, the init's line — seconds, weight bytes, and its peak over
    what was resident before it)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    cfg = get_config(arch)
    model = steps.serving_model(cfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [t for _, t in zoo.flatten(params)]
    weights = sum(t.numel() * t.element_size() for t in leaves)
    peak = torch.cuda.max_memory_allocated() - resident
    return cfg, model, params, gen, {
        "arch": arch, "n_params": sum(t.numel() for t in leaves),
        "param_dtype": "bfloat16", "init_s": init_s,
        "weights_gib": weights / 2**30, "init_peak_gib": peak / 2**30,
        "init_transient_gib": (peak - weights) / 2**30,
        "resident_before_gib": resident / 2**30}


@contextlib.contextmanager
def routes():
    """The (sel, keep) of every MoE layer run inside, in order."""
    from repro_torch.models import moe
    got = []
    moe.route_hook = lambda sel, keep: got.append((sel, keep))
    try:
        yield got
    finally:
        moe.route_hook = None


def route_flips(torch, a, b):
    """Tokens whose top-k expert sets differ between two runs' selections
    (a list of (B, S, k) a layer each), summed over the layers; None
    without MoE layers."""
    if not a and not b:
        return None
    check(len(a) == len(b), f"routes of {len(a)} and {len(b)} layers")
    return sum(int((torch.sort(x, -1).values != torch.sort(y, -1).values)
                   .any(-1).sum()) for x, y in zip(a, b))


def attention_apps(cfg) -> int:
    """Applications of attention in one prefill: a layer each for the
    dense, MoE and VLM families, none for the SSM, one a group of SSM
    layers for the hybrid, one an encoder layer and two (self and cross) a
    decoder layer for the enc-dec."""
    from repro_torch.models import hybrid
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return hybrid.group_shape(cfg)[0]
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def cache_bytes(cache, keys) -> int:
    """Bytes of the tensors under ``keys`` of a decode cache (those it
    has; a key may hold a tree or one tensor)."""
    from repro_torch.models import zoo
    return sum(t.nbytes for k in keys if k in cache
               for _, t in zoo.flatten({k: cache[k]}))


def serve_timed(torch, path, cfg, model, params, batch, max_len,
                flash_prefill_ms):
    """One warm prefill (its MoE routes recorded), then one prefill and
    ``LM_DECODE`` greedy decode steps, counted: (logits of every step, the
    timing line, launches, the warm prefill's routes).  The kernel must
    launch once an application of attention (``attention_apps``) and never
    in a decode step; a path without attention (the SSM) counts its
    launches without requiring one, and ``flash_prefill_ms`` (the kernel's
    time over one prefill's launches, from the timed kernel cases) is
    then None.  The
    flash launches of the prefill and of the decode steps are printed
    apart."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    prefill = steps.build_prefill_step(model, max_len)
    decode = steps.build_decode_step(model)
    with routes() as warm:
        prefill(params, batch)                   # warm: cuBLAS, the kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        t0 = time.perf_counter()
        cache, logits = prefill(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pre_launches = fa.launches
        outs, tok = [logits], logits.argmax(-1).to(torch.int32)
        for _ in range(LM_DECODE):
            cache, logits = decode(params, cache, tok)
            outs.append(logits)
            tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        return (outs, t1 - t0, time.perf_counter() - t1, pre_launches,
                cache_bytes(cache, ("kv",)),
                cache_bytes(cache, ("ssm", "ssm_groups", "ssm_tail")),
                cache_bytes(cache, ("cross_k", "cross_v")))

    apps = attention_apps(cfg)
    (outs, pre_s, dec_s, pre_launches, kv_bytes, ssm_bytes, cross_bytes), \
        launches = counted(torch, path, ("flash_attention",) if apps else (),
                           run)
    dec_launches = launches["flash_attention"] - pre_launches
    check(dec_launches == 0, f"{path}: flash_attention launched "
          f"{dec_launches} times in {LM_DECODE} decode steps")
    peak = torch.cuda.max_memory_allocated()
    greedy = torch.stack([o.argmax(-1)[:, 0] for o in outs], 1)
    B = batch["tokens"].shape[0]
    S = batch["tokens"].shape[1] + cfg.n_patches
    line = {"batch": B, "prompt": S, "decode_steps": LM_DECODE,
            "prefill_ms": pre_s * 1e3, "prefill_tokens_s": B * S / pre_s,
            "decode_ms_per_step": dec_s * 1e3 / LM_DECODE,
            "decode_tokens_s": B * LM_DECODE / dec_s,
            "flash_launches": launches["flash_attention"],
            "flash_launches_prefill": pre_launches,
            "flash_launches_decode": dec_launches,
            "attention_apps": apps,
            "flash_share_of_prefill": (flash_prefill_ms / (pre_s * 1e3)
                                       if apps else 0.0),
            "max_memory_allocated": peak, "max_memory_gib": peak / 2**30,
            "kv_cache_gib": kv_bytes / 2**30, "kv_cache_bytes": kv_bytes,
            "ssm_cache_bytes": ssm_bytes, "cross_kv_cache_bytes": cross_bytes,
            "greedy_tokens_row0": greedy[0].tolist()}
    return outs, line, launches, warm


def check_launches(path, cfg, launches):
    apps = attention_apps(cfg)
    check(launches["flash_attention"] == apps,
          f"{path}: flash_attention launched {launches['flash_attention']} "
          f"times in one prefill, not once an application of attention "
          f"({apps})")


def check_a(torch, model, params, batch, max_len):
    """(a): the last-position logits of the kernel prefill against the
    same prefill with the plain attention; (rel, logits, route flips)."""
    from repro_torch.launch import steps
    with routes() as ra:
        _, got = steps.build_prefill_step(model, max_len)(params, batch)
    with routes() as rb:
        _, want = steps.build_prefill_step(model, max_len, attn_impl="ref")(
            params, batch)
    return (rel_err(torch, got, want), [got, want],
            route_flips(torch, [s for s, _ in ra], [s for s, _ in rb]))


def check_b(torch, model, params, batch, token, longer, max_len):
    """(b): prefill + one decode step of ``token`` against a prefill one
    token longer (the twin of tests/test_archs.py); (rel, logits, route
    flips: the prefill's and decode's routes against the longer one's)."""
    from repro_torch.launch import steps
    pre = steps.build_prefill_step(model, max_len)
    with routes() as r1:
        cache, _ = pre(params, batch)
        _, dec = steps.build_decode_step(model)(params, cache, token)
    del cache
    with routes() as r2:
        _, full = pre(params, longer)
    n = len(r2)
    joined = [torch.cat([r1[i][0], r1[n + i][0]], 1) for i in range(n)]
    return (rel_err(torch, dec, full), [dec, full],
            route_flips(torch, joined, [sel for sel, _ in r2]))


def serve_checks(torch, path, cfg, model, params, batch, token, longer,
                 max_len, outs):
    """(a), (b) in bf16 (printed only) and in float32 on the same weights
    widened (checked within ``LM_F32_TOL``), (d) every logit finite."""
    import dataclasses
    from repro_torch.models import zoo
    a16, la16, _ = check_a(torch, model, params, batch, max_len)
    b16, lb16, _ = check_b(torch, model, params, batch, token, longer,
                           max_len)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = zoo.tree_map(lambda _, t: t.float(), params)
    model32 = zoo.build(cfg32, DEVICE)
    a, la, fa_ = check_a(torch, model32, params32, batch, max_len)
    b, lb, fb = check_b(torch, model32, params32, batch, token, longer,
                        max_len)
    finite = all(bool(torch.isfinite(t).all())
                 for t in outs + la16 + lb16 + la + lb)
    emit({"phase": "compare", "path": path, "dtype": "float32",
          "batch": batch["tokens"].shape[0],
          "prompt": batch["tokens"].shape[1] + cfg.n_patches,
          "a_kernel_vs_plain_prefill": a, "a_tol": LM_F32_TOL,
          "b_prefill_decode_vs_longer_prefill": b, "b_tol": LM_F32_TOL,
          "c": "(a) in float32, which (a) is",
          "d_all_logits_finite": finite,
          "a_bf16_not_checked": a16, "b_bf16_not_checked": b16})
    check(a < LM_F32_TOL, f"{path} (a): float32 kernel prefill vs plain {a}")
    check(b < LM_F32_TOL, f"{path} (b): float32 prefill + decode vs longer "
          f"prefill {b}")
    check(finite, f"{path} (d): a logit is not finite")
    del params32


def lm_phase(torch, flash_ms):
    """Path d: llama3.2-3b prefill + greedy decode on the card, counted,
    then checks (a)-(d)."""
    cfg, model, params, gen, init = serve_init(torch, LM_ARCH)
    B, S = LM_BATCH, LM_PROMPT
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    max_len = S + LM_DECODE
    batch = {"tokens": toks[:, :S]}
    outs, line, launches, _ = serve_timed(
        torch, "lm", cfg, model, params, batch, max_len,
        attention_apps(cfg) * flash_ms)
    emit({"phase": "main", "path": "lm", **init, **line})
    check_launches("lm", cfg, launches)
    # In bf16 (a) and (b) read the rounding noise of these random weights
    # (printed only); the checks run on the same weights and activations
    # in float32.
    serve_checks(torch, "lm", cfg, model, params, batch, toks[:, S:S + 1],
                 {"tokens": toks}, max_len, outs)
    del params, outs
    torch.cuda.empty_cache()
    return launches, line


def moe_phase(torch):
    """Path k: qwen3-moe-30b-a3b at full width and depth — the flash kernel
    at its attention shape, bf16 serving weights from seed 2016, 4 prompts
    of 4096 tokens and 32 greedy decode steps, counted; then, at full
    width and a depth of ``MOE_CHECK_LAYERS`` in float32 (the same first
    layers, widened), (a) at the main prompt and (b) at the dropless
    prompt ``MOE_DROPLESS_PROMPT``, with the route flips printed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe, zoo
    t_path = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    B, S = LM_BATCH, LM_PROMPT
    row = flash_case(torch, B, cfg.n_heads, cfg.n_kv_heads, S, cfg.hd,
                     SEED + 7)
    emit({"phase": "kernel", "path": "moe", **row})
    check_flash_case("moe", row)
    cfg, model, params, gen, init = serve_init(torch, MOE_ARCH)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    max_len = S + LM_DECODE
    batch = {"tokens": toks[:, :S]}
    outs, line, launches, warm = serve_timed(
        torch, "moe", cfg, model, params, batch, max_len,
        attention_apps(cfg) * row["ms"])
    dropped = [int((~keep).sum()) for _, keep in warm]
    dropped_line = {
          "capacity": moe._capacity(cfg, S),
          "pairs_per_layer": B * S * cfg.top_k,
          "dropped_pairs_per_layer": dropped,
          "dropped_share": sum(dropped) / (len(dropped) * B * S * cfg.top_k)}
    emit({"phase": "main", "path": "moe", **init, **line, **dropped_line})
    check_launches("moe", cfg, launches)
    check(init["init_transient_gib"] <= 2.0, "moe: the init's peak is "
          f"{init['init_transient_gib']} GiB over the weights, not <= 2")
    check(len(dropped) == cfg.n_layers, f"moe: {len(dropped)} routed layers")
    finite = all(bool(torch.isfinite(t).all()) for t in outs)
    n = MOE_CHECK_LAYERS
    cfg32 = dataclasses.replace(cfg, n_layers=n, dtype="float32",
                                param_dtype="float32")
    params32 = {"embed": zoo.tree_map(lambda _, t: t.float(),
                                      params["embed"]),
                "final_norm": zoo.tree_map(lambda _, t: t.float(),
                                           params["final_norm"]),
                "layers": zoo.tree_map(lambda _, t: t[:n].float(),
                                       params["layers"])}
    del params, outs
    gc.collect()
    torch.cuda.empty_cache()
    model32 = zoo.build(cfg32, DEVICE)
    a, la, flips_a = check_a(torch, model32, params32, batch, max_len)
    sb = MOE_DROPLESS_PROMPT
    check((sb + 1) * cfg.top_k <= 4096, "moe (b): the prompt is not dropless")
    b, lb, flips_b = check_b(torch, model32, params32,
                             {"tokens": toks[:, :sb]}, toks[:, sb:sb + 1],
                             {"tokens": toks[:, :sb + 1]}, sb + 1)
    finite = finite and all(bool(torch.isfinite(t).all()) for t in la + lb)
    emit({"phase": "compare", "path": "moe", "dtype": "float32",
          "layers": n, "batch": B, "prompt": S,
          "a_kernel_vs_plain_prefill": a, "a_tol": LM_F32_TOL,
          "a_route_flips": flips_a, "a_routed_tokens": n * B * S,
          "b_prompt": sb, "b_prefill_decode_vs_longer_prefill": b,
          "b_tol": LM_F32_TOL, "b_route_flips": flips_b,
          "b_routed_tokens": n * B * (sb + 1),
          "d_all_logits_finite": finite})
    check(a < LM_F32_TOL, f"moe (a): float32 kernel prefill vs plain {a} "
          f"({flips_a} route flips)")
    check(b < LM_F32_TOL, f"moe (b): float32 prefill + decode vs longer "
          f"prefill {b} ({flips_b} route flips)")
    check(finite, "moe (d): a logit is not finite")
    del params32, la, lb
    torch.cuda.empty_cache()
    emit({"phase": "moe", "path": "k", "seconds": time.perf_counter() - t_path})
    return launches, dict(line, **dropped_line)


def vlm_phase(torch):
    """Path l: paligemma-3b at full width and depth — the flash kernel at
    its attention shape (MQA, head dim 256: the FMA body), bf16 serving
    weights from seed 2016, 4 prompts of 256 patch embeddings (normal,
    bf16) and 3840 tokens, 32 greedy decode steps, counted; then (a), (b)
    and (d) as path lm, in float32 at full depth."""
    from repro_torch.configs import get_config
    t_path = time.perf_counter()
    cfg = get_config(VLM_ARCH)
    B, S = LM_BATCH, LM_PROMPT
    row = flash_case(torch, B, cfg.n_heads, cfg.n_kv_heads, S, cfg.hd,
                     SEED + 8)
    emit({"phase": "kernel", "path": "vlm", **row})
    check_flash_case("vlm", row)
    cfg, model, params, gen, init = serve_init(torch, VLM_ARCH)
    T = S - cfg.n_patches
    patches = torch.randn((B, cfg.n_patches, cfg.d_model), generator=gen,
                          device=DEVICE, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (B, T + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    max_len = S + LM_DECODE
    batch = {"tokens": toks[:, :T], "patch_embs": patches}
    outs, line, launches, _ = serve_timed(
        torch, "vlm", cfg, model, params, batch, max_len,
        attention_apps(cfg) * row["ms"])
    emit({"phase": "main", "path": "vlm", **init, **line,
          "patches": cfg.n_patches, "text_tokens": T})
    check_launches("vlm", cfg, launches)
    serve_checks(torch, "vlm", cfg, model, params, batch, toks[:, T:T + 1],
                 {"tokens": toks, "patch_embs": patches}, max_len, outs)
    del params, outs
    torch.cuda.empty_cache()
    emit({"phase": "vlm", "path": "l", "seconds": time.perf_counter() - t_path})
    return launches


def scan_vs_recurrence(torch, cfg32, params32, toks):
    """(e): layer 0's ``apply_ssm`` (the chunked scan) over the prompt
    against the same layer run token by token through ``apply_ssm_decode``
    from a zero cache, in float32: (output rel, final state rel, window
    rel, seconds of the token loop)."""
    from repro_torch.models import layers as L, ssm, transformer
    blk = transformer.layer(params32["layers"], 0)
    with torch.no_grad():
        x = L.embed_tokens(cfg32, params32["embed"], toks)
        h = L.apply_norm(cfg32, blk["ln"], x)
        y, state, window = ssm.apply_ssm(cfg32, blk["ssm"], h)
        cache = ssm.init_ssm_cache(cfg32, h.shape[0], torch.float32, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ys = [ssm.apply_ssm_decode(cfg32, blk["ssm"], h[:, t:t + 1], cache)[0]
              for t in range(h.shape[1])]
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    return (rel_err(torch, y, torch.cat(ys, 1)),
            rel_err(torch, state, cache["state"]),
            rel_err(torch, window, cache["conv"]), loop_s)


def ssm_phase(torch):
    """Path m: mamba2-1.3b at full width and depth — bf16 serving weights
    from seed 2016, 4 prompts of 4096 tokens and 32 greedy decode steps,
    counted (no attention: flash launches 0 times, checked); then in
    float32 at full depth (b) prefill + decode against a prefill one token
    longer (4097 tokens: the pad path), (e) layer 0's chunked scan over
    the prompt against its token-by-token recurrence, (d) every logit
    finite.  (a), the kernel against plain attention, does not apply."""
    import dataclasses
    from repro_torch.models import zoo
    t_path = time.perf_counter()
    cfg, model, params, gen, init = serve_init(torch, SSM_ARCH)
    B, S = LM_BATCH, LM_PROMPT
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    max_len = S + LM_DECODE
    batch = {"tokens": toks[:, :S]}
    outs, line, launches, _ = serve_timed(torch, "ssm", cfg, model, params,
                                          batch, max_len, None)
    line = {"phase": "main", "path": "ssm", **init, **line,
            "ssm_cache_gib": line["ssm_cache_bytes"] / 2**30}
    emit(line)
    check_launches("ssm", cfg, launches)
    finite = all(bool(torch.isfinite(t).all()) for t in outs)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = zoo.tree_map(lambda _, t: t.float(), params)
    del params, outs
    gc.collect()
    torch.cuda.empty_cache()
    model32 = zoo.build(cfg32, DEVICE)
    b, lb, _ = check_b(torch, model32, params32, batch, toks[:, S:S + 1],
                       {"tokens": toks}, max_len)
    e_y, e_state, e_window, loop_s = scan_vs_recurrence(
        torch, cfg32, params32, toks[:, :S])
    finite = finite and all(bool(torch.isfinite(t).all()) for t in lb)
    emit({"phase": "compare", "path": "ssm", "dtype": "float32",
          "layers": cfg.n_layers, "batch": B, "prompt": S,
          "a": "does not apply: no attention",
          "b_prefill_decode_vs_longer_prefill": b, "b_tol": LM_F32_TOL,
          "e_scan_vs_recurrence_y": e_y, "e_state": e_state,
          "e_window": e_window, "e_tol": LM_F32_TOL,
          "e_recurrence_s": loop_s, "d_all_logits_finite": finite})
    check(b < LM_F32_TOL, f"ssm (b): float32 prefill + decode vs longer "
          f"prefill {b}")
    check(max(e_y, e_state, e_window) < LM_F32_TOL, f"ssm (e): chunked "
          f"scan vs recurrence: y {e_y}, state {e_state}, window {e_window}")
    check(finite, "ssm (d): a logit is not finite")
    del params32, lb
    torch.cuda.empty_cache()
    emit({"phase": "ssm", "path": "m", "seconds": time.perf_counter() - t_path})
    return launches, line


def hybrid_phase(torch):
    """Path n: zamba2-7b — the flash kernel at its attention shape (MHA,
    head dim 112: the FMA body) as in path k, then full width and depth
    (81 layers: 13 groups of 6 and a tail of 3), bf16 serving weights from
    seed 2016, 4 prompts of 4096 tokens and 32 greedy decode steps,
    counted (13 launches a prefill: one an application of the shared
    block); then (a), (b) and (d) as path lm, in float32 at full depth,
    and the bf16 (a) and (b) at a depth of ``HYBRID_SHALLOW_LAYERS``
    (printed only)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid, zoo
    t_path = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    B, S = LM_BATCH, LM_PROMPT
    row = flash_case(torch, B, cfg.n_heads, cfg.n_kv_heads, S, cfg.hd,
                     SEED + 9)
    emit({"phase": "kernel", "path": "hybrid", **row})
    check_flash_case("hybrid", row)
    cfg, model, params, gen, init = serve_init(torch, HYBRID_ARCH)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    max_len = S + LM_DECODE
    batch = {"tokens": toks[:, :S]}
    outs, line, launches, _ = serve_timed(
        torch, "hybrid", cfg, model, params, batch, max_len,
        attention_apps(cfg) * row["ms"])
    line = {"phase": "main", "path": "hybrid", **init, **line,
            "groups_every_tail": list(hybrid.group_shape(cfg)),
            "ssm_cache_gib": line["ssm_cache_bytes"] / 2**30}
    emit(line)
    check_launches("hybrid", cfg, launches)
    longer = {"tokens": toks}
    n = HYBRID_SHALLOW_LAYERS
    cfg_n = dataclasses.replace(cfg, n_layers=n)
    n_groups = hybrid.group_shape(cfg_n)[0]
    params_n = dict(params, groups=zoo.tree_map(lambda _, t: t[:n_groups],
                                                params["groups"]))
    model_n = zoo.build(cfg_n, DEVICE)
    a16 = check_a(torch, model_n, params_n, batch, max_len)[0]
    b16 = check_b(torch, model_n, params_n, batch, toks[:, S:S + 1], longer,
                  max_len)[0]
    emit({"phase": "compare", "path": "hybrid", "dtype": "bfloat16",
          "layers": n, "groups_every_tail": list(hybrid.group_shape(cfg_n)),
          "a_bf16_not_checked": a16, "b_bf16_not_checked": b16})
    del params_n
    torch.cuda.reset_peak_memory_stats()
    serve_checks(torch, "hybrid", cfg, model, params, batch,
                 toks[:, S:S + 1], longer, max_len, outs)
    emit({"phase": "memory", "path": "hybrid",
          "checks_max_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    del params, outs
    torch.cuda.empty_cache()
    emit({"phase": "hybrid", "path": "n",
          "seconds": time.perf_counter() - t_path})
    return launches, line


def encdec_floors(cfg, B, S, max_len) -> dict:
    """Path o's floors on the card (989 TFLOP/s bf16, 3.35 TB/s): a
    prefill's operations — the encoder's projections and attention, the
    decoder's projections, self- and cross-attention, the cross K/V, the
    last position's logits — and a decode step's bytes: the decoder's
    weights but the cross K/V projections, the output embedding, the cross
    K/V cache and the self K/V cache at ``max_len``, bf16."""
    d, f, E, L, V = cfg.d_model, cfg.d_ff, cfg.enc_len, cfg.n_layers, cfg.vocab
    da, dkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    qkvo, mlp = 2 * d * da + 2 * d * dkv, 2 * d * f
    enc = cfg.n_enc_layers * (2 * B * E * (qkvo + mlp)
                              + 4 * B * cfg.n_heads * E * E * cfg.hd)
    dec = L * (2 * B * S * (qkvo + 2 * d * da + mlp)
               + 2 * B * E * 2 * d * dkv
               + 2 * B * cfg.n_heads * S * S * cfg.hd
               + 4 * B * cfg.n_heads * S * E * cfg.hd)
    ops = enc + dec + 2 * B * d * V
    weights = 2 * (L * (qkvo + 2 * d * da + mlp) + d * V)
    cross_kv = 2 * 2 * L * B * E * dkv
    self_kv = 2 * 2 * L * B * max_len * dkv
    return {"prefill_flop": ops, "prefill_floor_ms": ops / BF16_FLOP_S * 1e3,
            "decode_bytes": weights + cross_kv + self_kv,
            "decode_floor_ms": (weights + cross_kv + self_kv)
            / HBM_BYTES_S * 1e3,
            "cross_kv_bytes_expected": cross_kv,
            "self_kv_bytes_expected": self_kv}


def encdec_train(torch, cfg, gen, o=None):
    """o-train: whisper-medium's train step at full width and depth, f32
    masters, bf16 activations and AdamW moments, remat, path j's learning
    rate; one warm step and ``ENCDEC_TRAIN_STEPS`` timed ones on batches of
    ``ENCDEC_TRAIN_BATCH`` × 448 tokens from the token stream and normal
    frames; no kernel may launch (the train attention never reaches
    ``ops.attention``).  Given path o's line ``o``, r3-train: the same over
    ``ENCDEC_TP_MESH`` positions of the card, each its ``model`` share,
    the warm step's gradients one block a position, the timed steps' peak
    over what was resident before the parameters (the account's cell)."""
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    from repro_torch.optim import adam, schedule
    B, S = ENCDEC_TRAIN_BATCH, ENCDEC_PROMPT + LM_DECODE
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    model = zoo.build(cfg, DEVICE)
    params = model.init(gen)
    if o is not None:
        mesh = shard_mesh(torch, ENCDEC_TP_MESH, ("data", "model"))
        p_shapes, p_axes = model.abstract_params()
        params = shd.place_tree(params,
                                shd.tree_shardings(p_axes, p_shapes, mesh))
        gc.collect()
        torch.cuda.empty_cache()
    opt = adam.init(params)
    it = DataIterator(DataConfig(seq_len=S, global_batch=B, vocab=cfg.vocab,
                                 seed=SEED), device=DEVICE)
    zero_counts()
    rows, losses, blocks = [], [], {}
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + ENCDEC_TRAIN_STEPS):
        if i == 1 and o is not None:
            torch.cuda.reset_peak_memory_stats()
        batch = dict(next(it), frames=torch.randn(
            (B, cfg.enc_len, cfg.d_model), generator=gen,
            device=DEVICE))
        lr = adam.AdamConfig().lr * float(
            schedule.warmup_cosine(i, warmup=TRAIN_WARMUP))
        step = steps.build_train_step(model, adam.AdamConfig(lr=lr))
        real = grad_blocks_spy(torch, steps, blocks) \
            if i == 0 and o is not None else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            params, opt, met = step(params, opt, batch)
        finally:
            if real is not None:
                steps._grad_tree = real
        loss = float(met["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        rows.append({"step": i, "warm": i == 0, "ms": ms, "lr": lr,
                     "loss": loss, "grad_norm": float(met["grad_norm"])})
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    whole = sum(t.numel() * t.dtype.itemsize for _, t in zoo.flatten(params))
    arm = "train" if o is None else "r3-train"
    out = {"phase": "main", "path": "o" if o is None else "r", "arm": arm,
           "arch": cfg.name,
           "n_params": sum(t.numel() for _, t in zoo.flatten(params)),
           "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "moment_dtype": "bfloat16", "remat": cfg.remat, "global_batch": B,
           "seq": S, "frames": cfg.enc_len, "steps": rows,
           "mean_ms": sum(r["ms"] for r in rows[1:]) / ENCDEC_TRAIN_STEPS,
           "max_memory_allocated": peak, "max_memory_gib": peak / 2**30,
           "kernel_launches": launches}
    if o is not None:
        out.update(mesh=dict(zip(("data", "model"), ENCDEC_TP_MESH)),
                   o_train_mean_ms=o["train_mean_ms"],
                   vs_o=out["mean_ms"] / o["train_mean_ms"],
                   o_train_max_memory_gib=o["train_max_memory_gib"],
                   step_peak_bytes=peak - resident,
                   grad_blocks=grad_blocks_line(blocks, whole))
    emit(out)
    check(all(map(math.isfinite, losses)),
          f"{arm}: a loss is not finite {losses}")
    check(not any(launches.values()),
          f"{arm}: the train step launched a kernel {launches}")
    check(o is None or (blocks.get("held") and blocks["held"] ==
                        blocks["want"] and not blocks["off"]),
          f"{arm}: the gradients are not one block a position: "
          f"{out.get('grad_blocks')}")
    del params, opt, it, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def encdec_phase(torch):
    """Path o: whisper-medium — the flash kernel at its three attention
    shapes (the encoder's q, k, v (4, 16, 1500, 64) and the cross-
    attention's q (4, 16, 416, 64) over k, v (4, 16, 1500, 64), not causal;
    the decoder's (4, 16, 416, 64), causal; all on the ``wgmma`` body);
    then full width and depth (24 encoder + 24 decoder layers, d_model
    1024, 16 heads of 64), bf16 serving weights from seed 2016, 4 × 1500
    normal bf16 frame embeddings (the stub frontend's), 4 prompts of 416
    tokens and 32 greedy decode steps (448 positions, whisper's text
    context), counted (72 launches a prefill, none in decode); the
    encoder alone timed once; then (a), (b) and (d) as path lm, in float32
    at full depth with the same frames in every batch; then o-train."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    t_path = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    B, S, E = LM_BATCH, ENCDEC_PROMPT, cfg.enc_len
    flash = {}
    for i, (name, s_, t_, causal) in enumerate((
            ("encoder", E, E, False), ("cross", S, E, False),
            ("decoder", S, S, True))):
        row = flash_case(torch, B, cfg.n_heads, cfg.n_kv_heads, s_, cfg.hd,
                         SEED + 10 + i, T=t_, causal=causal)
        emit({"phase": "kernel", "path": "encdec", "attention": name, **row})
        check_flash_case("encdec", row)
        flash[name] = row["ms"]
    per_prefill = (cfg.n_enc_layers * flash["encoder"]
                   + cfg.n_layers * (flash["cross"] + flash["decoder"]))
    cfg, model, params, gen, init = serve_init(torch, ENCDEC_ARCH)
    frames = torch.randn((B, E, cfg.d_model), generator=gen, device=DEVICE,
                         dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    max_len = S + LM_DECODE
    batch = {"tokens": toks[:, :S], "frames": frames}
    outs, line, launches, _ = serve_timed(
        torch, "encdec", cfg, model, params, batch, max_len, per_prefill)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encdec.encode(cfg, params, frames)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
    floors = encdec_floors(cfg, B, S, max_len)
    emit({"phase": "main", "path": "encdec", **init, **line, "frames": E,
          "encoder_ms": enc_ms, "flash_ms_per_prefill": per_prefill,
          "cross_kv_cache_gib": line["cross_kv_cache_bytes"] / 2**30,
          **floors})
    check_launches("encdec", cfg, launches)
    check(line["cross_kv_cache_bytes"] == floors["cross_kv_bytes_expected"]
          and line["kv_cache_bytes"] == floors["self_kv_bytes_expected"],
          f"encdec: cache bytes {line['kv_cache_bytes']} self, "
          f"{line['cross_kv_cache_bytes']} cross")
    serve_checks(torch, "encdec", cfg, model, params, batch,
                 toks[:, S:S + 1], {"tokens": toks, "frames": frames},
                 max_len, outs)
    del params, outs, model
    gc.collect()
    torch.cuda.empty_cache()
    train = encdec_train(torch, get_config(ENCDEC_ARCH), gen)
    emit({"phase": "encdec", "path": "o",
          "seconds": time.perf_counter() - t_path})
    return launches, dict(line, encoder_ms=enc_ms, train_mean_ms=train[
        "mean_ms"], train_max_memory_gib=train["max_memory_gib"])


def max_rel(torch, a: dict, b: dict) -> float:
    """Largest over the keys of max |a - b| / max |b|."""
    return max(rel_err(torch, a[k], b[k]) for k in b)


def blockwise_row(torch):
    """j1: blockwise attention at the full-width layer shape (f32, causal)
    against the grouped route under autograd, on the same inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    cfg = get_config(TRAIN_ARCH)
    S, nh, nkv, hd = TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 6)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)
    q, k, v = draw(1, S, nh, hd), draw(1, S, nkv, hd), draw(1, S, nkv, hd)
    dout = draw(1, S, nh * hd)
    for t in (q, k, v):
        t.requires_grad_(True)
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE)[None]

    def blockwise():
        return layers.blockwise_attention(q, k, v, pos, pos, True, TRAIN_BK)

    def grouped():
        return layers._grouped_attention(q, k, v,
                                         layers.causal_mask(pos, pos))

    def run(fn):
        out = fn()
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        return {"out": out.detach(), "dq": dq, "dk": dk, "dv": dv}

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(), (q, k, v), dout)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = run(blockwise)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    want = run(grouped)
    errs = {k_: rel_err(torch, got[k_], want[k_]) for k_ in want}
    with torch.no_grad():
        fwd_ms = time_ms(torch, blockwise, reps=3)
        g_fwd_ms = time_ms(torch, grouped, reps=3)
    row = {"phase": "train", "path": "j1", "name": "blockwise_attention",
           "shape": f"q (1, {S}, {nh}, {hd}), k/v (1, {S}, {nkv}, {hd}) "
                    f"f32, causal, bk {TRAIN_BK}",
           "rel_err": errs, "tol": TRAIN_TOL,
           "fwd_ms": fwd_ms, "fwd_bwd_ms": time_ms(torch, fwd_bwd(blockwise),
                                                   reps=3),
           "grouped_fwd_ms": g_fwd_ms,
           "grouped_fwd_bwd_ms": time_ms(torch, fwd_bwd(grouped), reps=3),
           "peak_bytes_fwd_bwd": peak}
    emit(row)
    check(max(errs.values()) <= TRAIN_TOL,
          f"j1: blockwise attention against the grouped route {errs}")
    del q, k, v, dout, got, want
    torch.cuda.empty_cache()
    return row


def train_step_phase(torch):
    """j2: llama3.2-3b's train step at full width and depth, bf16
    activations over f32 masters, remat, bf16 moments; one warm step, then
    TRAIN_STEPS timed steps on successive batches of the token stream."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    from repro_torch.optim import adam, schedule
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), grad_accum=TRAIN_ACCUM)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    model = zoo.build(cfg, DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen)
    opt = adam.init(params)
    it = DataIterator(DataConfig(seq_len=S, global_batch=B, vocab=cfg.vocab,
                                 seed=SEED), device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in zoo.flatten(params))
    flops = (6 * n_params * B * S
             + 12 * cfg.n_layers * S * S * cfg.hd * cfg.n_heads * B)
    zero_counts()
    rows, losses = [], []
    for i in range(1 + TRAIN_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        batch = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lr = adam.AdamConfig().lr * float(
            schedule.warmup_cosine(i, warmup=TRAIN_WARMUP))
        step = steps.build_train_step(model, adam.AdamConfig(lr=lr))
        params, opt, met = step(params, opt, batch)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        ms = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        rows.append({"step": i, "warm": i == 0, "ms": ms,
                     "lr": lr,
                     "tokens_s": B * S / ms * 1e3, "loss": loss,
                     "grad_norm": gnorm,
                     "flop_share_989": flops / (ms / 1e3) / BF16_FLOP_S})
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts()
    finite = all(bool(torch.isfinite(t).all()) for _, t in
                 zoo.flatten(params)) and all(
        bool(torch.isfinite(t.float()).all()) for m in ("m", "v")
        for _, t in zoo.flatten(opt[m]))
    timed = rows[1:]
    out = {"phase": "main", "path": "j", "arm": "j2", "arch": TRAIN_ARCH,
           "n_params": n_params, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "moment_dtype": "bfloat16", "remat": cfg.remat,
           "seq": S, "global_batch": B, "grad_accum": TRAIN_ACCUM,
           "lr": f"3e-4 × warmup_cosine(step, warmup={TRAIN_WARMUP})",
           "cut": f"global batch {B} (train_4k: 256) in {TRAIN_ACCUM} "
                  f"microbatches of {B // TRAIN_ACCUM}; weights random "
                  f"(seed {SEED}); tokens from DataIterator (seed {SEED})",
           "init_s": init_s, "steps": rows,
           "mean_ms": sum(r["ms"] for r in timed) / len(timed),
           "mean_tokens_s": sum(r["tokens_s"] for r in timed) / len(timed),
           "model_flops_per_step": flops,
           "flops_formula": "6·N·tokens + 12·L·S²·d_head·n_heads·B",
           "max_memory_allocated": peak, "max_memory_gib": peak / 2**30,
           "resident_before_gib": resident / 2**30,
           "kernel_launches": launches, "all_finite": finite}
    emit(out)
    check(finite and all(map(math.isfinite, losses)),
          "j2: a loss, parameter or moment is not finite")
    check(losses[-1] < losses[0], f"j2: the loss did not fall {losses}")
    check(not any(launches.values()),
          f"j2: the train step launched a kernel {launches}: the train "
          "forward must not reach ops.attention")
    del params, opt, it, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_checks_phase(torch):
    """j3: at full width and a depth of TRAIN_CHECK_LAYERS, float32 compute:
    gradients with remat on against off, grad_accum 2 against 1 over the
    same batch, and the blockwise route against the grouped one at
    S = TRAIN_SEQ (the threshold raised for the run)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.launch import steps
    from repro_torch.models import layers, zoo
    base = dataclasses.replace(get_config(TRAIN_ARCH),
                               n_layers=TRAIN_CHECK_LAYERS, dtype="float32")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 7)
    params = zoo.build(base, DEVICE).init(gen)
    batch = next(DataIterator(DataConfig(seq_len=TRAIN_SEQ,
                                         global_batch=TRAIN_BATCH,
                                         vocab=base.vocab, seed=SEED),
                              device=DEVICE))

    def grads(**over):
        model = zoo.build(dataclasses.replace(base, **over), DEVICE)
        t0 = time.perf_counter()
        loss, _, g = steps.loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        out = {k: v.detach().clone() for k, v in zoo.flatten(g)}
        for _, p in zoo.flatten(params):
            p.grad = None
        return float(loss), out, (time.perf_counter() - t0) * 1e3

    l_on, g_on, ms_on = grads(remat=True)
    l_off, g_off, ms_off = grads(remat=False)
    l_acc, g_acc, ms_acc = grads(remat=True, grad_accum=2)
    saved = layers._BLOCKWISE_THRESHOLD
    layers._BLOCKWISE_THRESHOLD = TRAIN_SEQ    # S·T = threshold²: grouped
    try:
        l_grp, g_grp, ms_grp = grads(remat=True)
    finally:
        layers._BLOCKWISE_THRESHOLD = saved
    errs = {"remat_on_vs_off": max_rel(torch, g_on, g_off),
            "accum2_vs_accum1": max_rel(torch, g_acc, g_on),
            "blockwise_vs_grouped": max_rel(torch, g_on, g_grp)}
    out = {"phase": "compare", "path": "j", "arm": "j3",
           "arch": TRAIN_ARCH, "n_layers": TRAIN_CHECK_LAYERS,
           "cut": f"depth {TRAIN_CHECK_LAYERS} of 28 at full width",
           "dtype": "float32", "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
           "grad_rel_err": errs, "tol": TRAIN_TOL,
           "losses": {"remat_on": l_on, "remat_off": l_off,
                      "accum2": l_acc, "grouped": l_grp},
           "ms": {"remat_on": ms_on, "remat_off": ms_off, "accum2": ms_acc,
                  "grouped": ms_grp}}
    emit(out)
    for name, e in errs.items():
        check(e <= TRAIN_TOL, f"j3 {name}: gradients differ by {e}")
    del params, g_on, g_off, g_acc, g_grp
    torch.cuda.empty_cache()
    return out


def train_main_phase(torch):
    """j4: ``launch.train.main`` over qwen2-0.5b at full width and depth —
    4 steps with a checkpoint every 2, then ``--resume`` to step 6 — and
    the checkpoint's round trip: the last step restored onto the card and
    saved again writes the same bytes (every leaf's CRC-32 equal), so the
    restored parameters and moments are the saved ones bit for bit."""
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core import fm
    from repro_torch.launch import train
    from repro_torch.models import zoo
    from repro_torch.optim import adam
    d = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    argv = ["--arch", TRAIN_MAIN_ARCH, "--batch", "4", "--seq", "1024",
            "--ckpt-dir", str(d), "--ckpt-every", "2", "--log-every", "1"]
    try:
        with fm.conf(device=DEVICE):
            t0 = time.perf_counter()
            first = train.main(argv + ["--steps", "4"])
            t1 = time.perf_counter()
            resumed = train.main(argv + ["--steps", "6", "--resume"])
            t2 = time.perf_counter()
        ck = Checkpointer(str(d))
        last = ck.latest_step()
        cfg = get_config(TRAIN_MAIN_ARCH)
        model = zoo.build(cfg, DEVICE)
        template = {"params": model.init(0)}
        template["opt"] = adam.init(template["params"])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        state, step, extra = ck.restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t3
        t3 = time.perf_counter()
        ck.save(last + 1000, state, extra=extra, blocking=True)
        save_s = time.perf_counter() - t3
        man = {s_: json.loads((d / f"step_{s_:010d}" / "manifest.json")
                              .read_text())["leaves"]
               for s_ in (last, last + 1000)}
        same = {k: man[last][k]["crc32"] == man[last + 1000][k]["crc32"]
                for k in man[last]}
        nbytes = sum(f.stat().st_size
                     for f in (d / f"step_{last:010d}").iterdir())
        bf16 = sorted({v["dtype"] for v in man[last].values()})
        out = {"phase": "main", "path": "j", "arm": "j4",
               "arch": TRAIN_MAIN_ARCH, "n_layers": cfg.n_layers,
               "argv": argv, "losses": first, "resumed_losses": resumed,
               "first_run_s": t1 - t0, "resume_run_s": t2 - t1,
               "checkpoint_step": last, "checkpoint_bytes": nbytes,
               "leaves": len(same), "leaf_dtypes": bf16,
               "restore_s": restore_s, "save_s": save_s,
               "round_trip_bit_for_bit": all(same.values()),
               "extra": extra}
        emit(out)
        check(len(resumed) == 2, f"j4: the resume ran {len(resumed)} steps, "
              "not 2")
        check(all(map(math.isfinite, first + resumed)),
              "j4: a loss is not finite")
        check(step == last == 6 and extra["data"]["step"] == 6,
              f"j4: restored step {step}, latest {last}, extra {extra}")
        check(all(same.values()), "j4: the restored state saved again "
              f"differs from the checkpoint in "
              f"{[k for k, v in same.items() if not v]}")
        del state, template
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def train_path(torch):
    """Path j: training, after path lm with the serving weights freed;
    returns j2's line."""
    t0 = time.perf_counter()
    blockwise_row(torch)
    j2 = train_step_phase(torch)
    train_checks_phase(torch)
    train_main_phase(torch)
    emit({"phase": "train", "path": "j", "seconds": time.perf_counter() - t0})
    return j2


def shard_mesh(torch, shape, names):
    """Positions of the one card laid out as ``shape`` over ``names``."""
    import numpy as np
    from repro_torch.launch.mesh import Mesh
    n = math.prod(shape)
    devs = np.array([torch.device(DEVICE, 0)] * n, dtype=object)
    return Mesh(devs.reshape(shape), names)


def shard_layout(params, opt) -> dict:
    """Each position's stored bytes of every parameter and moment against
    its spec's block: (leaves checked, bytes held, positions off)."""
    from repro_torch.models import zoo
    held, off, n = 0, [], 0
    trees = {"params": params, "m": opt["m"], "v": opt["v"]}
    for tname, tree in trees.items():
        for name, leaf in zoo.flatten(tree):
            n += 1
            sh = leaf.sharding
            want = sh.shard_shape(leaf.shape)
            for pos in sh.positions():
                t = leaf.local(pos)
                nb = t.untyped_storage().nbytes()
                held += nb
                if (tuple(t.shape) != want or nb != math.prod(want)
                        * t.element_size()):
                    off.append(f"{tname}.{name}@{pos}")
    return {"leaves": n, "bytes": held, "off": off}


def grad_blocks_spy(torch, steps, seen):
    """Wrap ``steps._grad_tree`` to read the step's gradient blocks just
    before they are laid out: every leaf must have one tensor a block's
    first copy, of the block's shape and storage, on its position's
    device — one gradient block a position.  ``seen`` gets each position's
    bytes held, what the spec says it should hold (each of its blocks
    once) and the leaves off.  Returns the function to put back."""
    real = steps._grad_tree

    def spy(params, blocks):
        from repro_torch.models import zoo
        held, want, off = {}, {}, []
        for name, p in zoo.flatten(params):
            sh, block = p.sharding, p.sharding.shard_shape(p.shape)
            firsts = {pos for pos in sh.positions() if sh.is_first_copy(pos)}
            nb = math.prod(block) * p.dtype.itemsize
            for pos in firsts:
                want[pos] = want.get(pos, 0) + nb
            bufs = blocks.get(name, {})
            if set(bufs) != firsts:
                off.append(f"{name}: positions {sorted(bufs)}")
            for pos, g in bufs.items():
                size = g.untyped_storage().nbytes()
                held[pos] = held.get(pos, 0) + size
                if (tuple(g.shape) != block or size != nb
                        or g.device != p.local(pos).device):
                    off.append(f"{name}@{pos}")
        seen.update(held=held, want=want, off=off)
        return real(params, blocks)
    steps._grad_tree = spy
    return real


def grad_blocks_line(seen, whole) -> dict:
    held = seen.get("held", {})
    return {"whole_grad_bytes": whole,
            "held_by_position": {str(k): v for k, v in held.items()},
            "max_share_of_whole": max(held.values(), default=0) / whole,
            "as_spec": held == seen.get("want"),
            "off": seen.get("off", ["not read"])[:8]}


def shard_step_phase(torch, j2, shape=SHARD_MESH, arm="p1"):
    """llama3.2-3b's train step at full width and depth over (data, model)
    = ``shape`` positions of the card, j2's settings: p1 over (2, 2), each
    position computing its ``model`` share; p0 over (1, 1), the path
    ``launch.train`` takes on one device, against j2's ``loss_and_grads``
    path.  The warm step's gradient blocks are read before they are laid
    out (``grad_blocks_spy``): one a position."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    from repro_torch.optim import adam, schedule
    from repro_torch.runtime import rescale_grad_accum
    mesh = shard_mesh(torch, shape, ("data", "model"))
    accum = rescale_grad_accum(TRAIN_ACCUM, old_data=1, new_data=shape[0])
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), grad_accum=accum)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    model = zoo.build(cfg, DEVICE)
    t0 = time.perf_counter()
    p_shapes, p_axes = model.abstract_params()
    p_sh = shd.tree_shardings(p_axes, p_shapes, mesh)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    params = shd.place_tree(model.init(gen), p_sh)
    gc.collect()
    torch.cuda.empty_cache()
    opt = adam.init(params)
    rows = shd.sharding_for("batch|seq", (B, S), mesh)
    it = DataIterator(DataConfig(seq_len=S, global_batch=B, vocab=cfg.vocab,
                                 seed=SEED),
                      sharding={"tokens": rows, "labels": rows})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layout = shard_layout(params, opt)
    zero_counts()
    out_rows, losses, grad_blocks = [], [], {}
    for i in range(1 + SHARD_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        batch = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lr = adam.AdamConfig().lr * float(
            schedule.warmup_cosine(i, warmup=TRAIN_WARMUP))
        step = steps.build_train_step(model, adam.AdamConfig(lr=lr))
        real = grad_blocks_spy(torch, steps, grad_blocks) if i == 0 else None
        try:
            params, opt, met = step(params, opt, batch)
        finally:
            if real is not None:
                steps._grad_tree = real
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        ms = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        out_rows.append({"step": i, "warm": i == 0, "ms": ms, "lr": lr,
                         "tokens_s": B * S / ms * 1e3, "loss": loss,
                         "grad_norm": gnorm})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    whole = sum(p.numel() * p.dtype.itemsize
                for _, p in zoo.flatten(params))
    launches = read_counts()
    timed = out_rows[1:]
    mean_ms = sum(r["ms"] for r in timed) / len(timed)
    held = grad_blocks.get("held", {})
    out = {"phase": "main", "path": "p", "arm": arm, "arch": TRAIN_ARCH,
           "mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
           "devices": f"[{DEVICE}:0] x {mesh.devices.size}",
           "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "moment_dtype": "bfloat16",
           "remat": cfg.remat, "seq": S, "global_batch": B,
           "grad_accum": accum, "init_s": init_s, "steps": out_rows,
           "mean_ms": mean_ms,
           "mean_tokens_s": sum(r["tokens_s"] for r in timed) / len(timed),
           "j2_mean_ms": j2["mean_ms"], "vs_j2": mean_ms / j2["mean_ms"],
           "max_memory_allocated": peak, "max_memory_gib": peak / 2**30,
           "resident_before": resident, "step_peak_bytes": peak - resident,
           "j2_max_memory_gib": j2["max_memory_gib"],
           "layout": {"leaves": layout["leaves"],
                      "bytes_held": layout["bytes"],
                      "positions_off": layout["off"]},
           "grad_blocks": grad_blocks_line(grad_blocks, whole),
           "kernel_launches": launches}
    emit(out)
    check(not layout["off"], f"{arm}: positions hold other than their "
          f"block: {layout['off'][:8]}")
    check(held and held == grad_blocks["want"] and not grad_blocks["off"],
          f"{arm}: the gradients are not one block a position: "
          f"{out['grad_blocks']}")
    check(all(map(math.isfinite, losses)), f"{arm}: a loss is not finite "
          f"{losses}")
    check(not any(launches.values()),
          f"{arm}: the sharded train step launched a kernel {launches}")
    del params, opt, it, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shard_grads_phase(torch):
    """p2 at full width and a depth of SHARD_CHECK_LAYERS, float32: one
    sharded step over (data 2, model 2) — each position its ``model``
    share — against the unsharded one (``tp_grads_arm``).  Returns the
    model, its sharded parameters and their sharded gradients."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.models import zoo
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=SHARD_CHECK_LAYERS, dtype="float32")
    model = zoo.build(cfg, DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 8)
    params = model.init(gen)
    batch = next(DataIterator(DataConfig(seq_len=TRAIN_SEQ,
                                         global_batch=TRAIN_BATCH,
                                         vocab=cfg.vocab, seed=SEED),
                              device=DEVICE))
    _, sparams, gs = tp_grads_arm(torch, "p", "p2", model, params, batch,
                                  SHARD_MESH)
    return model, sparams, gs


def shard_restore_phase(torch, model, sparams, gs):
    """p3: the state after one sharded AdamW step, saved on (2, 2), restored
    onto the replanned (1, 2)."""
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import zoo
    from repro_torch.optim import adam
    from repro_torch.runtime import replan_mesh
    mesh = sparams["embed"]["tok"].sharding.mesh
    opt = adam.init(sparams)
    sparams, opt, _ = adam.update(gs, opt, sparams)
    state = {"params": sparams, "opt": opt}
    d = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_shard_"))
    try:
        ck = Checkpointer(str(d))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(1, state, blocking=True)
        save_s = time.perf_counter() - t0
        mesh_b = replan_mesh(2, prefer_model=2,
                             devices=[torch.device(DEVICE, 0)] * 2)
        p_shapes, p_axes = model.abstract_params()
        sh_b = {"params": shd.tree_shardings(p_axes, p_shapes, mesh_b),
                "opt": shd.tree_shardings(adam.opt_state_axes(p_axes),
                                          opt, mesh_b)}
        t0 = time.perf_counter()
        got, step, _ = ck.restore(state, shardings=sh_b)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want_sh, saved = dict(zoo.flatten(sh_b)), dict(zoo.flatten(state))
        bad = [k for k, v in zoo.flatten(got)
               if v.sharding != want_sh[k] or v.dtype != saved[k].dtype
               or not torch.equal(v.full(), saved[k].full())]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out = {"phase": "compare", "path": "p", "arm": "p3",
           "from": dict(zip(mesh.axis_names, mesh.devices.shape)),
           "to": dict(zip(mesh_b.axis_names, mesh_b.devices.shape)),
           "leaves": len(want_sh), "step": step, "save_s": save_s,
           "restore_s": restore_s, "leaves_off": bad}
    emit(out)
    check(step == 1 and not bad, f"p3: restored leaves differ {bad}")
    return out


def shard_int8_phase(torch, gs):
    """p4: the int8 cross-pod reduction over 4 pod positions of the card,
    on the gradient tree as AdamW takes it (clipped to norm 1)."""
    import numpy as np
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import zoo
    from repro_torch.optim import adam, compression
    pods = shard_mesh(torch, (4,), ("pod",))
    rep = shd.NamedSharding(pods, ())
    clip = min(1.0, 1.0 / float(adam.global_norm(gs)))
    grads, exact = {}, {}
    for k, g in zoo.flatten(gs):
        full = g.full() * clip
        shards = np.empty((4,), dtype=object)
        for i in range(4):
            shards[i] = full * ((i + 1) / 4)
        grads[k] = shd.ShardedTensor(shards, rep, full.shape, full.dtype)
        exact[k] = full * 2.5
        del full
    err = compression.init_error_state(grads)
    total = {k: torch.zeros_like(v) for k, v in exact.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SHARD_INT8_ROUNDS):
        red, err = compression.cross_pod_psum_int8(grads, err, "pod")
        for k in total:
            total[k] += red[k].local((0,))
        del red
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3 / SHARD_INT8_ROUNDS
    worst, bad = 0.0, []
    for k in total:
        mean = total[k] / SHARD_INT8_ROUNDS
        excess = ((mean - exact[k]).abs()
                  - (2e-5 + 0.05 * exact[k].abs())).max()
        worst = max(worst, float((mean - exact[k]).abs().max()))
        if float(excess) > 0:
            bad.append(k)
    out = {"phase": "compare", "path": "p", "arm": "p4",
           "pods": 4, "leaves": len(total),
           "elements": sum(v.numel() for v in total.values()),
           "clip": clip,
           "amax": max(float(v.abs().max()) for v in exact.values()) / 2.5,
           "rounds": SHARD_INT8_ROUNDS, "ms_a_round": round_ms,
           "max_abs_err_of_mean": worst, "rtol": 0.05, "atol": 2e-5,
           "leaves_off": bad}
    emit(out)
    check(not bad, f"p4: the int8 mean is off the exact sum in {bad}")
    return out


def shard_path(torch, j2):
    """Path p: sharded training over positions of the one card."""
    t0 = time.perf_counter()
    p0 = shard_step_phase(torch, j2, (1, 1), "p0")
    p1 = shard_step_phase(torch, j2)
    model, sparams, gs = shard_grads_phase(torch)
    shard_restore_phase(torch, model, sparams, gs)
    del model, sparams
    gc.collect()
    torch.cuda.empty_cache()
    shard_int8_phase(torch, gs)
    del gs
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train", "path": "p", "seconds": time.perf_counter() - t0})
    return p0, p1


def held_bytes(tree) -> tuple:
    """(bytes each position holds of a tree of ``ShardedTensor``, the
    leaves' positions holding other than their spec's block)."""
    from repro_torch.models import zoo
    held, off = {}, []
    for name, leaf in zoo.flatten(tree):
        want = leaf.sharding.shard_shape(leaf.shape)
        for pos in leaf.sharding.positions():
            t = leaf.local(pos)
            nb = t.untyped_storage().nbytes()
            held[pos] = held.get(pos, 0) + nb
            if tuple(t.shape) != want or nb != math.prod(want) * \
                    t.element_size():
                off.append(f"{name}@{pos}")
    return held, off


def mesh_serve_run(torch, model, params, toks, max_len, steps_n,
                   shape=SERVE_MESH, placed=None):
    """A prefill of ``toks`` (the prompts' tokens, or a batch with an
    enc-dec's frames) and ``steps_n`` greedy decode steps over (data,
    model) = ``shape`` positions of the card: the parameters laid out by
    ``prefill_specs``' shardings (FSDP) for the prefill, re-laid out by
    ``decode_specs``' under ``serve_mode`` (weights resident over
    ``data``) for the decode — or ``placed``, parameters already laid out,
    for both where the two layouts agree; one warm prefill first.  Returns
    (decode parameters, cache, every step's logits, the greedy tokens,
    prefill s, decode s, prefill peak, decode peak, the prefill's flash
    launches); the launch counts are set to 0 after the warm prefill."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    mesh = shard_mesh(torch, shape, ("data", "model"))
    p_shapes, p_axes = model.abstract_params()
    p_sh = shd.tree_shardings(p_axes, p_shapes, mesh)
    with shd.serve_mode():
        d_sh = shd.tree_shardings(p_axes, p_shapes, mesh)
    prefill = steps.build_prefill_step(model, max_len)
    decode = steps.build_decode_step(model)
    batch = toks if isinstance(toks, dict) else {"tokens": toks}
    torch.cuda.synchronize()
    if placed is None:
        base = torch.cuda.memory_allocated()
        sp = shd.place_tree(params, p_sh)
    else:
        check(p_sh == d_sh and shd.tree_map(
            lambda t: t.sharding, placed) == p_sh,
              "the prefill's and the decode's layouts differ")
        sp = placed
        base = torch.cuda.memory_allocated() - sum(held_bytes(sp)[0].values())
    prefill(sp, batch)                       # warm: the rows' streams, cuBLAS
    gc.collect()
    torch.cuda.synchronize()
    zero_counts()                            # the warm prefill's launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache, lg = prefill(sp, batch)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pre_peak = torch.cuda.max_memory_allocated() - base
    pre_launches = read_counts()["flash_attention"]
    if placed is None:
        del sp
        sd = shd.place_tree(params, d_sh)
    else:
        sd = sp
    torch.cuda.synchronize()
    dec_base = (torch.cuda.memory_allocated()
                - sum(held_bytes(sd)[0].values())
                - sum(held_bytes(cache)[0].values()))
    torch.cuda.reset_peak_memory_stats()
    outs, greedy = [lg], []
    t1 = time.perf_counter()
    for _ in range(steps_n):
        greedy.append(outs[-1].full().argmax(-1).to(torch.int32))
        cache, lg = decode(sd, cache, greedy[-1])
        outs.append(lg)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t1
    dec_peak = torch.cuda.max_memory_allocated() - dec_base
    return (sd, cache, outs, greedy, pre_s, dec_s, pre_peak, dec_peak,
            pre_launches)


def _full(t):
    """A ``ShardedTensor`` gathered whole; a tensor as it is."""
    return t.full() if hasattr(t, "full") else t


def rows_alone_devs(torch, model, params, toks, max_len, cache, outs, greedy,
                    n_rows=SERVE_MESH[0], path="q1"):
    """Each data row's prompts (of ``toks``: tokens, or a batch) run alone,
    unsharded, through the mesh run's greedy tokens: per step the largest
    logit deviation relative to the largest logit, the cache rows' largest
    relative deviation, and the share of steps whose greedy token the rows
    alone pick too.  ``cache`` and ``outs`` may also be one device's run
    of the whole batch (plain tensors)."""
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    prefill = steps.build_prefill_step(model, max_len)
    decode = steps.build_decode_step(model)
    c_axes = dict(zoo.flatten(model.cache_axes()))
    batch = toks if isinstance(toks, dict) else {"tokens": toks}
    b = batch["tokens"].shape[0] // n_rows
    by_step = [0.0] * len(outs)
    cache_dev, agree, n = 0.0, 0, 0
    for r in range(n_rows):
        span = slice(r * b, (r + 1) * b)
        c1, l1 = prefill(params, {k: v[span] for k, v in batch.items()})
        by_step[0] = max(by_step[0], rel_err(torch, _full(outs[0])[span], l1))
        for i, tok in enumerate(greedy):
            agree += int(torch.equal(l1.argmax(-1).to(torch.int32),
                                     tok[span]))
            n += 1
            c1, l1 = decode(params, c1, tok[span])
            by_step[i + 1] = max(by_step[i + 1],
                                 rel_err(torch, _full(outs[i + 1])[span], l1))
        for name, leaf in zoo.flatten(cache):
            want = dict(zoo.flatten(c1))[name]
            if name == "len":
                check(all(torch.equal(t, want) for t in (
                    [leaf.local(p) for p in leaf.sharding.positions()]
                    if hasattr(leaf, "sharding") else [leaf])),
                      f"{path}: len differs from the rows alone")
                continue
            dim = c_axes[name].split("|").index("batch")
            cache_dev = max(cache_dev, rel_err(
                torch, _full(leaf).narrow(dim, span.start, b), want))
        del c1, l1
    return by_step, cache_dev, agree / max(n, 1)


def mesh_serve_f32(torch):
    """q1's float32 arm: llama3.2-3b at full width, depth
    ``SERVE_F32_LAYERS``, float32 weights and activations from seed 2026,
    served over ``SERVE_MESH`` positions (``SERVE_F32_STEPS`` greedy
    steps) against the rows alone (``tp_serve_f32_arm``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=SERVE_F32_LAYERS, dtype="float32",
                              param_dtype="float32")
    model = zoo.build(cfg, DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 10)
    params = model.init(gen)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    line = tp_serve_f32_arm(torch, "q", "q1-f32", model, params,
                            {"tokens": toks}, SERVE_F32_STEPS, SERVE_MESH)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return line


def mesh_serve_phase(torch, lm):
    """q1: llama3.2-3b served over (data, model) = ``SERVE_MESH`` positions
    of the card, each position computing its ``model`` share, path lm's
    weights and prompts (seed 2016): first the flash kernel at a
    position's shape against its plain version, then one warm prefill and
    the counted run (``mesh_serve_run``), then each data row's prompts
    run alone, unsharded, through the same greedy tokens: each step's
    largest logit deviation and the greedy tokens' agreement printed (the
    bf16 rounding of these random weights: not checked); then the float32
    arm (``mesh_serve_f32``), checked.  Returns the path's launches and its
    line (with the cell's measured peaks)."""
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    n_rows, n_model = SERVE_MESH
    kernel = flash_case(torch, LM_BATCH // n_rows, cfg.n_heads // n_model,
                        cfg.n_kv_heads // n_model, LM_PROMPT, cfg.hd,
                        SEED + 9)
    emit({"phase": "kernel", "path": "q", **kernel})
    check_flash_case("q", kernel)
    cfg, model, params, gen, init = serve_init(torch, LM_ARCH)
    B, S = LM_BATCH, LM_PROMPT
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    max_len = S + SERVE_DECODE
    (sd, cache, outs, greedy, pre_s, dec_s, pre_peak, dec_peak,
     pre_launches), launches = counted(
        torch, "q1", ("flash_attention",),
        lambda: mesh_serve_run(torch, model, params, toks[:, :S], max_len,
                               SERVE_DECODE))
    apps = attention_apps(cfg) * n_rows * n_model
    by_step, cache_dev, agree = rows_alone_devs(
        torch, model, params, toks[:, :S], max_len, cache, outs, greedy)
    held_p, off_p = held_bytes(sd)
    held_c, off_c = held_bytes(cache)
    tokens = torch.stack([g[:, 0] for g in greedy], 1)
    line = {"phase": "main", "path": "q", "arm": "q1", "arch": LM_ARCH,
            "mesh": dict(zip(("data", "model"), SERVE_MESH)),
            "devices": f"[{DEVICE}:0] x {n_rows * n_model}",
            "tensor_parallel": True,
            "batch": B, "prompt": S, "decode_steps": SERVE_DECODE,
            "prefill_ms": pre_s * 1e3, "lm_prefill_ms": lm["prefill_ms"],
            "decode_ms_per_step": dec_s * 1e3 / SERVE_DECODE,
            "lm_decode_ms_per_step": lm["decode_ms_per_step"],
            "decode_vs_lm": dec_s * 1e3 / SERVE_DECODE
            / lm["decode_ms_per_step"],
            "prefill_peak_bytes": pre_peak, "decode_peak_bytes": dec_peak,
            "prefill_peak_gib": pre_peak / 2**30,
            "decode_peak_gib": dec_peak / 2**30,
            "lm_max_memory_gib": lm["max_memory_gib"],
            "held_by_position": {str(p): held_p[p] + held_c[p]
                                 for p in held_p},
            "params_held_by_position": {str(p): v for p, v in held_p.items()},
            "positions_off": (off_p + off_c)[:8],
            "flash_launches": launches["flash_attention"],
            "flash_launches_prefill": pre_launches,
            "rows_logits_rel_dev_by_step_bf16": by_step,
            "rows_cache_rel_dev_bf16": cache_dev,
            "rows_greedy_agreement_bf16": agree,
            "greedy_tokens_row0": tokens[0].tolist(),
            "lm_greedy_tokens_row0": lm["greedy_tokens_row0"],
            "greedy_row0_as_lm": tokens[0].tolist() ==
            lm["greedy_tokens_row0"][:SERVE_DECODE],
            **{k: init[k] for k in ("init_s", "weights_gib")}}
    emit(line)
    check(pre_launches == apps and launches["flash_attention"] == apps,
          f"q1: flash_attention launched {pre_launches} times in the "
          f"prefill and {launches['flash_attention']} in all, not "
          f"{apps} (a layer a position) and none in decode")
    check(not off_p and not off_c, f"q1: positions hold other than their "
          f"blocks {(off_p + off_c)[:8]}")
    check(all(bool(torch.isfinite(o.full()).all()) for o in outs),
          "q1: a logit is not finite")
    del params, sd, cache, outs
    gc.collect()
    torch.cuda.empty_cache()
    line["f32"] = mesh_serve_f32(torch)
    return launches, line


def account_phase(torch, p0, p1, q1):
    """q2: the account of p0's, p1's and q1's cells (``account_cells``)."""
    from repro_torch.configs.base import ShapeSpec
    train = ShapeSpec("j2", TRAIN_SEQ, TRAIN_BATCH, "train")
    account_cells(torch, "q", "q2", TRAIN_ARCH, [
        ("p0", (1, 1), p0["grad_accum"], train, p0["step_peak_bytes"],
         {"step_ms": p0["mean_ms"]}),
        ("p1", SHARD_MESH, p1["grad_accum"], train, p1["step_peak_bytes"],
         {"step_ms": p1["mean_ms"]}),
        ("q1-prefill", SERVE_MESH, 1,
         ShapeSpec("q1p", LM_PROMPT, LM_BATCH, "prefill"),
         q1["prefill_peak_bytes"], {"prefill_ms": q1["prefill_ms"]}),
        ("q1-decode", SERVE_MESH, 1,
         ShapeSpec("q1d", LM_PROMPT + SERVE_DECODE, LM_BATCH, "decode"),
         q1["decode_peak_bytes"],
         {"decode_ms_per_step": q1["decode_ms_per_step"]})])


def account_cells(torch, path, arm, arch, cells, over=None):
    """The dry-run's account (``steps.lower_cell`` on meta tensors,
    ``one_device``: the positions share this card) of ``arch``'s cells
    (with ``over`` replacing fields of its config) —
    (name, (data, model), grad_accum, shape, measured peak, measured ms) —
    against the card's peak over what was resident before the cell's
    arguments were laid out, each within ``ACCOUNT_TOL``; the positions'
    summed ``peak_device_bytes`` printed beside it, and the roofline's
    terms beside the measured times."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline, steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import zoo
    cfg = dataclasses.replace(get_config(arch), **(over or {}))
    bad = []
    for name, shape, accum, spec, measured, ms in cells:
        n = math.prod(shape)
        mesh = Mesh(np.array([torch.device("meta")] * n,
                             dtype=object).reshape(shape), ("data", "model"))
        model = zoo.build(dataclasses.replace(cfg, grad_accum=accum), "meta")
        t0 = time.perf_counter()
        rec = steps.lower_cell(model, spec, mesh, one_device=True).record
        trace_s = time.perf_counter() - t0
        pred = rec["device_peak_bytes"]
        summed = sum(p["peak_device_bytes"] for p in rec["positions"])
        err = pred / measured - 1
        per = [roofline.terms(p) for p in rec["positions"]]
        slowest = max(per, key=lambda t: max(t.values()))
        coll = sum(p["collective_bytes_total"] for p in rec["positions"])
        one_card = {"compute_s": sum(t["compute"] for t in per),
                    "memory_s": sum(t["memory"] for t in per),
                    "copies_s": 2 * coll / roofline.HBM_BW}
        emit({"phase": "account", "path": path, "arm": arm, "cell": name,
              "arch": arch,
              "mesh": dict(zip(mesh.axis_names, shape)),
              "shape": [spec.global_batch, spec.seq_len, spec.kind],
              "grad_accum": accum, "trace_s": trace_s,
              "predicted_device_peak_bytes": pred,
              "summed_position_peak_bytes": summed,
              "measured_peak_bytes": measured, "rel_err": err,
              "tol": ACCOUNT_TOL,
              "position_peak_bytes": {str(tuple(p["pos"])):
                                      p["peak_device_bytes"]
                                      for p in rec["positions"]},
              "roofline_slowest_position_s": slowest,
              "roofline_one_card_s": one_card,
              "dot_flops_by_dtype": rec["loop_aware"]["dot_flops_by_dtype"],
              "kernels": rec["kernels"],
              "collectives": rec["collectives"], "measured": ms})
        if abs(err) > ACCOUNT_TOL:
            bad.append((name, err))
    check(not bad, f"{arm}: the account's peak is off the card's by more "
          f"than {ACCOUNT_TOL}: {bad}")


def mesh_serve_path(torch, lm, p0, p1):
    """Path q: serving over a mesh of the card's positions (q1) and the
    dry-run's account against the card (q2)."""
    t0 = time.perf_counter()
    launches, q1 = mesh_serve_phase(torch, lm)
    account_phase(torch, p0, p1, q1)
    emit({"phase": "serve", "path": "q", "seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# Path r: tensor-parallel compute over `model` for the MoE and enc-dec
# ---------------------------------------------------------------------------

def place_by_layer(torch, model, mesh, gen):
    """``model``'s parameters laid out on ``mesh`` by the decode cell's
    shardings (``serve_mode``) without a whole stacked leaf ever on the
    card: every position's blocks made as zeros, then layer by layer a
    one-layer model's draw from ``gen`` copied into them (the other
    leaves drawn with the first layer and placed); a hybrid's draw is one
    group of SSM layers and a tail layer, copied into group i and tail
    layer i.  Returns (the tree, the init's line: seconds, weight bytes,
    its peak over the weights)."""
    import dataclasses
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import zoo
    cfg = model.cfg
    shapes, axes = model.abstract_params()
    with shd.serve_mode():
        sh = dict(zoo.flatten(shd.tree_shardings(axes, shapes, mesh)))
    axes, shapes = dict(zoo.flatten(axes)), dict(zoo.flatten(shapes))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    one = zoo.build(dataclasses.replace(
        cfg, n_layers=cfg.shared_attn_every + 1 if cfg.family == "hybrid"
        else 1), DEVICE)
    draws = max(shapes[name].shape[0] for name in shapes
                if axes[name].startswith("layers"))
    placed = {}
    for i in range(draws):
        for name, t in zoo.flatten(one.init(gen)):
            if not axes[name].startswith("layers"):
                if i == 0:
                    placed[name] = shd.place(t, sh[name])
                continue
            lead = shapes[name].shape[0]
            if i >= lead:
                continue
            if name not in placed:
                placed[name] = shd.zeros(tuple(shapes[name].shape), t.dtype,
                                         sh[name])
            leaf = placed[name]
            k = axes[name].split("|").count("layers")
            for pos in sh[name].positions():
                sl = sh[name].slices(leaf.shape, pos)
                check(all(s_ == slice(0, n) for s_, n in
                          zip(sl[:k], leaf.shape)),
                      f"{name}: its layers are sharded")
                leaf.shards[pos][i].copy_(t[0][sl[1:]])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(sum(held_bytes({"x": leaf})[0].values())
                  for leaf in placed.values())
    whole = sum(t.numel() * t.element_size() for t in shapes.values())
    peak = torch.cuda.max_memory_allocated() - resident
    tree = zoo.tree_map(lambda name, _: placed[name],
                        model.abstract_params()[0])
    return tree, {"init_s": init_s, "weights_gib": whole / 2**30,
                  "weights_held_bytes": weights, "weights_bytes": whole,
                  "weight_copies": weights / whole,
                  "init_peak_gib": peak / 2**30,
                  "init_transient_gib": (peak - weights) / 2**30}


def rows_route_flips(torch, mesh_routes, alone, n_layers):
    """Route flips of a mesh prefill's MoE layers against one device's
    prefill of the whole batch (``alone``: its (B, S, k) a layer): the
    mesh's routes (thread, sel (b, S, k)) taken a thread's ``n_layers`` at
    a time — one data row's prefill — each held against the rows of the
    one-device batch it flips least against (the rows' prompts differ)."""
    by_thread = {}
    for ident, sel in mesh_routes:
        by_thread.setdefault(ident, []).append(sel)
    flips = 0
    for sels in by_thread.values():
        for c in range(0, len(sels), n_layers):
            chunk = sels[c:c + n_layers]
            b = chunk[0].shape[0]
            flips += min(route_flips(torch, chunk,
                                     [a[r:r + b] for a in alone])
                         for r in range(0, alone[0].shape[0], b))
    return flips


@contextlib.contextmanager
def thread_routes():
    """The (thread, sel) of every MoE layer run inside, in order."""
    from repro_torch.models import moe
    got = []
    moe.route_hook = lambda sel, keep: got.append(
        (threading.get_ident(), sel))
    try:
        yield got
    finally:
        moe.route_hook = None


def moe_tp_serve(torch, k):
    """r1: qwen3-moe-30b-a3b at full width and depth, bf16, over (data,
    model) = ``MOE_TP_MESH`` positions of the card — one copy of the
    weights, each position its 64 experts and 16 of the 32 heads: the
    flash kernel at a position's shape against its plain version; the
    parameters laid out a layer at a time (``place_by_layer``); path k's
    4 × 4096 prompts' shape (seed 2016) prefilled once warm, then counted
    with ``MOE_TP_DECODE`` greedy steps: ms beside path k's, each
    position's bytes, the peak, 48 flash launches a position in the
    prefill and none in decode, the dropped pairs a layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import moe
    cfg = get_config(MOE_ARCH)
    n_rows, n_model = MOE_TP_MESH
    kernel = flash_case(torch, LM_BATCH // n_rows, cfg.n_heads // n_model,
                        cfg.n_kv_heads // n_model, LM_PROMPT, cfg.hd,
                        SEED + 12)
    emit({"phase": "kernel", "path": "r", "arm": "r1", **kernel})
    check_flash_case("r1", kernel)
    model = steps.serving_model(cfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    mesh = shard_mesh(torch, MOE_TP_MESH, ("data", "model"))
    sp, init = place_by_layer(torch, model, mesh, gen)
    emit({"phase": "init", "path": "r", "arm": "r1", "arch": MOE_ARCH,
          **init})
    check(init["weight_copies"] < 1.01, f"r1: the positions hold "
          f"{init['weight_copies']} copies of the weights, not one")
    B, S = LM_BATCH, LM_PROMPT
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    max_len = S + MOE_TP_DECODE
    with routes() as got:
        (sd, cache, outs, greedy, pre_s, dec_s, pre_peak, dec_peak,
         pre_launches), launches = counted(
            torch, "r1", ("flash_attention",),
            lambda: mesh_serve_run(torch, model, None, toks, max_len,
                                   MOE_TP_DECODE, MOE_TP_MESH, placed=sp))
    L_ = cfg.n_layers
    dropped = [int((~keep).sum()) for _, keep in got[L_:2 * L_]]
    apps = attention_apps(cfg) * n_rows * n_model
    held_p, off_p = held_bytes(sd)
    held_c, off_c = held_bytes(cache)
    line = {"phase": "main", "path": "r", "arm": "r1", "arch": MOE_ARCH,
            "mesh": dict(zip(("data", "model"), MOE_TP_MESH)),
            "devices": f"[{DEVICE}:0] x {n_rows * n_model}",
            "tensor_parallel": True, "batch": B, "prompt": S,
            "decode_steps": MOE_TP_DECODE,
            "prefill_ms": pre_s * 1e3, "k_prefill_ms": k["prefill_ms"],
            "prefill_vs_k": pre_s * 1e3 / k["prefill_ms"],
            "decode_ms_per_step": dec_s * 1e3 / MOE_TP_DECODE,
            "k_decode_ms_per_step": k["decode_ms_per_step"],
            "decode_vs_k": dec_s * 1e3 / MOE_TP_DECODE
            / k["decode_ms_per_step"],
            "prefill_peak_bytes": pre_peak, "decode_peak_bytes": dec_peak,
            "prefill_peak_gib": pre_peak / 2**30,
            "decode_peak_gib": dec_peak / 2**30,
            "k_max_memory_gib": k["max_memory_gib"],
            "held_by_position": {str(p): held_p[p] + held_c[p]
                                 for p in held_p},
            "params_held_by_position": {str(p): v for p, v in held_p.items()},
            "positions_off": (off_p + off_c)[:8],
            "flash_launches": launches["flash_attention"],
            "flash_launches_prefill": pre_launches,
            "capacity": moe._capacity(cfg, S),
            "dropped_pairs_per_layer": dropped,
            "k_dropped_pairs_per_layer": k["dropped_pairs_per_layer"],
            "dropped_share": sum(dropped) / (L_ * B * S * cfg.top_k),
            "greedy_tokens_row0": [int(g[0, 0]) for g in greedy]}
    emit(line)
    check(pre_launches == apps and launches["flash_attention"] == apps,
          f"r1: flash_attention launched {pre_launches} times in the "
          f"prefill and {launches['flash_attention']} in all, not {apps} "
          f"(a layer a position) and none in decode")
    check(len(got) == L_ * (2 + MOE_TP_DECODE), f"r1: {len(got)} routes")
    check(not off_p and not off_c, f"r1: positions hold other than their "
          f"blocks {(off_p + off_c)[:8]}")
    check(all(bool(torch.isfinite(o.full()).all()) for o in outs),
          "r1: a logit is not finite")
    del sp, sd, cache, outs, got
    gc.collect()
    torch.cuda.empty_cache()
    return launches, line


def tp_grads_arm(torch, path, arm, model, params, batch, shape,
                 floor=False):
    """One sharded step over (data, model) = ``shape`` positions — each
    its ``model`` share — against the unsharded one (the loss within
    ``TP_TOL`` relative, each gradient leaf within ``TP_TOL`` of its
    largest entry), run to run bit for bit, its gradients one block a
    position (``grad_blocks_spy``); the line printed and checked.  With
    ``floor``, the unsharded step is also run as two microbatches (the same
    gradient, its sums in another order): each leaf's distance between the
    two is its float32 floor, and the leaf's bound is the larger of
    ``TP_TOL`` and ``FLOOR_FACTOR`` × its floor.  Returns (the line, the
    sharded parameters, their gradients)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    mesh = shard_mesh(torch, shape, ("data", "model"))
    p_shapes, p_axes = model.abstract_params()
    sparams = shd.place_tree(params,
                             shd.tree_shardings(p_axes, p_shapes, mesh))
    whole = sum(p.numel() * p.dtype.itemsize for _, p in zoo.flatten(params))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l1, _, g1 = steps.loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    ms1 = (time.perf_counter() - t0) * 1e3
    g1 = {k: v.detach().clone() for k, v in zoo.flatten(g1)}
    for _, p in zoo.flatten(params):
        p.grad = None
        p.requires_grad_(False)
    bounds = {k: TP_TOL for k in g1}
    if floor:
        import dataclasses
        two = zoo.build(dataclasses.replace(model.cfg, grad_accum=2), DEVICE)
        _, _, g2 = steps.loss_and_grads(two, params, batch)
        floor = {k: rel_err(torch, v, g1[k]) for k, v in zoo.flatten(g2)}
        for _, p in zoo.flatten(params):
            p.grad = None
            p.requires_grad_(False)
        del g2
        bounds = {k: max(TP_TOL, FLOOR_FACTOR * floor[k]) for k in g1}
    runs, seen = [], {}
    for i in range(2):
        real = grad_blocks_spy(torch, steps, seen) if i == 0 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            ls, _, gs = steps.sharded_loss_and_grads(model, sparams, batch)
        finally:
            if real is not None:
                steps._grad_tree = real
        torch.cuda.synchronize()
        runs.append((float(ls), gs, (time.perf_counter() - t0) * 1e3))
    (ls, gs, ms_s), (ls2, gs2, ms_s2) = runs
    del runs
    errs = {k: rel_err(torch, g.full(), g1[k]) for k, g in zoo.flatten(gs)}
    same = ls == ls2 and all(
        torch.equal(a.full(), b.full())
        for (_, a), (_, b) in zip(zoo.flatten(gs), zoo.flatten(gs2)))
    loss_rel = abs(ls - float(l1)) / abs(float(l1))
    del g1, gs2
    blocks = grad_blocks_line(seen, whole)
    out = {"phase": "compare", "path": path, "arm": arm,
           "arch": model.cfg.name, "n_layers": model.cfg.n_layers,
           "dtype": model.cfg.dtype,
           "mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
           "batch": {k: list(v.shape) for k, v in batch.items()},
           "loss_unsharded": float(l1), "loss_sharded": ls,
           "loss_rel": loss_rel, "loss_tol": TP_TOL,
           "grad_rel_err_max": max(errs.values()),
           "grad_worst_leaf": max(errs, key=errs.get), "tol": TP_TOL,
           "grad_rel_err_by_leaf": errs,
           **({"grad_floor_by_leaf": floor, "floor_factor": FLOOR_FACTOR,
               "grad_bound_by_leaf": bounds} if floor else {}),
           "bit_for_bit_run_to_run": same, "grad_blocks": blocks,
           "ms": {"unsharded": ms1, "sharded": ms_s, "sharded_again": ms_s2}}
    emit(out)
    check(loss_rel <= TP_TOL, f"{arm}: loss {ls} against {float(l1)} "
          f"unsharded")
    over = {k: (e, bounds[k]) for k, e in errs.items() if e > bounds[k]}
    check(not over, f"{arm}: gradients differ beyond their bounds {over}")
    check(same, f"{arm}: two sharded runs differ")
    check(blocks["as_spec"] and not seen.get("off"),
          f"{arm}: the gradients are not one block a position: {blocks}")
    return out, sparams, gs


def tp_serve_f32_arm(torch, path, arm, model, params, batch, steps_n, shape,
                     extra=None, floor=False):
    """A float32 prefill of ``batch`` and ``steps_n`` greedy decode steps
    over (data, model) = ``shape`` positions against each data row's
    prompts served alone, unsharded (``rows_alone_devs``): every step's
    logits and the cache rows within ``TP_TOL`` of the largest entry.
    With ``floor``, one device's run of the whole batch through the same
    tokens is held against the rows alone too (the same function at
    another batch shape): its deviations are the float32 floor, and each
    bound is the larger of ``TP_TOL`` and ``FLOOR_FACTOR`` × its floor."""
    from repro_torch.launch import steps
    S = batch["tokens"].shape[1]
    (_, cache, outs, greedy, pre_s, dec_s, _, _, _) = mesh_serve_run(
        torch, model, params, batch, S + steps_n, steps_n, shape)
    by_step, cache_dev, agree = rows_alone_devs(
        torch, model, params, batch, S + steps_n, cache, outs, greedy,
        shape[0], arm)
    step_bounds, cache_bound, extra = [TP_TOL] * len(by_step), TP_TOL, \
        dict(extra or {})
    if floor:
        one_c, lg = steps.build_prefill_step(model, S + steps_n)(params,
                                                                  batch)
        one = [lg]
        for tok in greedy:
            one_c, lg = steps.build_decode_step(model)(params, one_c, tok)
            one.append(lg)
        f_step, f_cache, _ = rows_alone_devs(
            torch, model, params, batch, S + steps_n, one_c, one, greedy,
            shape[0], arm)
        del one_c, one
        step_bounds = [max(TP_TOL, FLOOR_FACTOR * f) for f in f_step]
        cache_bound = max(TP_TOL, FLOOR_FACTOR * f_cache)
        extra.update(logits_floor_by_step=f_step, cache_floor=f_cache,
                     floor_factor=FLOOR_FACTOR,
                     logits_bound_by_step=step_bounds,
                     cache_bound=cache_bound)
    line = {"phase": "compare", "path": path, "arm": arm,
            "arch": model.cfg.name, "n_layers": model.cfg.n_layers,
            "dtype": "float32",
            "batch": {k: list(v.shape) for k, v in batch.items()},
            "decode_steps": steps_n,
            "mesh": dict(zip(("data", "model"), shape)),
            "logits_rel_dev_by_step": by_step,
            "cache_rel_dev": cache_dev, "greedy_agreement": agree,
            "tol": TP_TOL, "prefill_ms": pre_s * 1e3,
            "decode_ms_per_step": dec_s * 1e3 / steps_n, **extra}
    emit(line)
    check(all(d <= b for d, b in zip(by_step, step_bounds))
          and cache_dev <= cache_bound,
          f"{arm}: the mesh's logits or cache differ from the rows alone "
          f"by more than {step_bounds}, {cache_bound}: {by_step}, "
          f"{cache_dev}")
    del cache, outs
    gc.collect()
    torch.cuda.empty_cache()
    return line


def moe_tp_checks(torch):
    """r2: qwen3-moe-30b-a3b at full width, depth ``MOE_TP_CHECK_LAYERS``,
    float32 from seed 2029, over (data 2, model 2): a train step of 4 ×
    ``MOE_TP_TRAIN_SEQ`` tokens (capacity-bound: more than 4096 pairs a
    row) against the unsharded one (``tp_grads_arm``), then a prefill of
    4 × ``MOE_TP_TRAIN_SEQ`` and ``MOE_TP_DECODE`` greedy steps against
    each row served alone (``tp_serve_f32_arm``), the prefill's route
    flips against one device's printed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import zoo
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=MOE_TP_CHECK_LAYERS, dtype="float32",
                              param_dtype="float32", grad_accum=1)
    model = zoo.build(cfg, DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 13)
    params = model.init(gen)
    B, S = LM_BATCH, MOE_TP_TRAIN_SEQ
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    tp_grads_arm(torch, "r", "r2-train", model, params,
                 {"tokens": toks[:, :S], "labels": toks[:, 1:]}, (2, 2))
    prompt = {"tokens": toks[:, :S]}
    with routes() as one:
        steps.build_prefill_step(model, S)(params, prompt)
    mesh = shard_mesh(torch, (2, 2), ("data", "model"))
    from repro_torch.distributed import sharding as shd
    p_shapes, p_axes = model.abstract_params()
    sp = shd.place_tree(params, shd.tree_shardings(p_axes, p_shapes, mesh))
    with thread_routes() as two:
        steps.build_prefill_step(model, S)(sp, prompt)
    del sp
    flips = rows_route_flips(torch, two, [sel for sel, _ in one], cfg.n_layers)
    dropped = [int((~keep).sum()) for _, keep in one]
    tp_serve_f32_arm(torch, "r", "r2-serve", model, params, prompt,
                     MOE_TP_DECODE, (2, 2),
                     {"route_flips": flips,
                      "routed_tokens": cfg.n_layers * B * S,
                      "dropped_pairs_per_layer_one_device": dropped})
    del params
    gc.collect()
    torch.cuda.empty_cache()


def encdec_tp_phase(torch, o):
    """r3: whisper-medium over (data, model) = ``ENCDEC_TP_MESH`` positions
    of the card, each its 8 of the 16 heads of every encoder, decoder and
    cross-attention and its half of ``d_ff``: the flash kernel at a
    position's three shapes; bf16 serving at full width and depth (path
    o's shape: 4 × 1500 frames, 4 prompts of 416 tokens, seed 2016, one
    warm prefill, then counted with ``ENCDEC_TP_DECODE`` greedy steps) —
    ms beside path o's, 72 flash launches a position in the prefill and
    none in decode, the cross cache split by sequence; o-train's step
    over the positions (f32 masters, bf16 activations, remat, one warm
    and ``ENCDEC_TRAIN_STEPS`` timed steps, its peak); then float32 at
    full depth: a train step against the unsharded one and serving
    against the rows alone, within ``TP_TOL``.  Returns (launches, the
    train line)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    cfg = get_config(ENCDEC_ARCH)
    n_rows, n_model = ENCDEC_TP_MESH
    B, S, E = LM_BATCH, ENCDEC_PROMPT, cfg.enc_len
    b, h = B // n_rows, cfg.n_heads // n_model
    for i, (name, s_, t_, causal) in enumerate((
            ("encoder", E, E, False), ("cross", S, E, False),
            ("decoder", S, S, True))):
        row = flash_case(torch, b, h, cfg.n_kv_heads // n_model, s_, cfg.hd,
                         SEED + 14 + i, T=t_, causal=causal)
        emit({"phase": "kernel", "path": "r", "arm": "r3", "attention": name,
              **row})
        check_flash_case("r3", row)
    cfg, model, params, gen, init = serve_init(torch, ENCDEC_ARCH)
    frames = torch.randn((B, E, cfg.d_model), generator=gen, device=DEVICE,
                         dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    batch = {"tokens": toks, "frames": frames}
    max_len = S + ENCDEC_TP_DECODE
    (sd, cache, outs, greedy, pre_s, dec_s, pre_peak, dec_peak,
     pre_launches), launches = counted(
        torch, "r3", ("flash_attention",),
        lambda: mesh_serve_run(torch, model, params, batch, max_len,
                               ENCDEC_TP_DECODE, ENCDEC_TP_MESH))
    apps = attention_apps(cfg) * n_rows * n_model
    held_p, off_p = held_bytes(sd)
    held_c, off_c = held_bytes(cache)
    line = {"phase": "main", "path": "r", "arm": "r3-serve",
            "arch": ENCDEC_ARCH,
            "mesh": dict(zip(("data", "model"), ENCDEC_TP_MESH)),
            "devices": f"[{DEVICE}:0] x {n_rows * n_model}",
            "tensor_parallel": True, "batch": B, "frames": E, "prompt": S,
            "decode_steps": ENCDEC_TP_DECODE,
            "cross_cache_spec": str(cache["cross_k"].sharding.spec),
            "prefill_ms": pre_s * 1e3, "o_prefill_ms": o["prefill_ms"],
            "prefill_vs_o": pre_s * 1e3 / o["prefill_ms"],
            "decode_ms_per_step": dec_s * 1e3 / ENCDEC_TP_DECODE,
            "o_decode_ms_per_step": o["decode_ms_per_step"],
            "decode_vs_o": dec_s * 1e3 / ENCDEC_TP_DECODE
            / o["decode_ms_per_step"],
            "prefill_peak_gib": pre_peak / 2**30,
            "decode_peak_gib": dec_peak / 2**30,
            "held_by_position": {str(p): held_p[p] + held_c[p]
                                 for p in held_p},
            "positions_off": (off_p + off_c)[:8],
            "flash_launches": launches["flash_attention"],
            "flash_launches_prefill": pre_launches,
            "greedy_tokens_row0": [int(g[0, 0]) for g in greedy],
            **{k: init[k] for k in ("init_s", "weights_gib")}}
    emit(line)
    check(pre_launches == apps and launches["flash_attention"] == apps,
          f"r3: flash_attention launched {pre_launches} times in the "
          f"prefill and {launches['flash_attention']} in all, not {apps}")
    check(cache["cross_k"].sharding.spec[2] == "model",
          f"r3: the cross cache is laid out {cache['cross_k'].sharding.spec}")
    check(not off_p and not off_c, f"r3: positions hold other than their "
          f"blocks {(off_p + off_c)[:8]}")
    check(all(bool(torch.isfinite(t.full()).all()) for t in outs),
          "r3: a logit is not finite")
    del params, sd, cache, outs, model
    gc.collect()
    torch.cuda.empty_cache()
    train = encdec_train(torch, cfg, gen, o)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = zoo.build(cfg32, DEVICE)
    params32 = model32.init(gen)
    bt = ENCDEC_TRAIN_BATCH
    tr = torch.randint(0, cfg.vocab, (bt, S + 1), generator=gen,
                       device=DEVICE, dtype=torch.int32)
    f32 = torch.randn((bt, E, cfg.d_model), generator=gen, device=DEVICE)
    tp_grads_arm(torch, "r", "r3-train-f32", model32, params32,
                 {"tokens": tr[:, :S], "labels": tr[:, 1:], "frames": f32},
                 ENCDEC_TP_MESH)
    tp_serve_f32_arm(torch, "r", "r3-serve-f32", model32, params32,
                     {"tokens": toks, "frames": frames.float()},
                     ENCDEC_TP_DECODE, ENCDEC_TP_MESH)
    del params32, model32
    gc.collect()
    torch.cuda.empty_cache()
    return launches, line, train


def tp_families_path(torch, k, o):
    """Path r: the MoE (r1, r2) and the enc-dec (r3) computing over
    ``model``, and the account of r1's and r3's cells against the card
    (r4).  Returns the path's launches."""
    from repro_torch.configs.base import ShapeSpec
    t0 = time.perf_counter()
    r1_launches, r1 = moe_tp_serve(torch, k)
    moe_tp_checks(torch)
    r3_launches, r3, r3_train = encdec_tp_phase(torch, o)
    account_cells(torch, "r", "r4", MOE_ARCH, [
        ("r1-prefill", MOE_TP_MESH, 1,
         ShapeSpec("r1p", LM_PROMPT, LM_BATCH, "prefill"),
         r1["prefill_peak_bytes"], {"prefill_ms": r1["prefill_ms"]}),
        ("r1-decode", MOE_TP_MESH, 1,
         ShapeSpec("r1d", LM_PROMPT + MOE_TP_DECODE, LM_BATCH, "decode"),
         r1["decode_peak_bytes"],
         {"decode_ms_per_step": r1["decode_ms_per_step"]})])
    account_cells(torch, "r", "r4", ENCDEC_ARCH, [
        ("r3-train", ENCDEC_TP_MESH, 1,
         ShapeSpec("r3t", ENCDEC_PROMPT + LM_DECODE, ENCDEC_TRAIN_BATCH,
                   "train"),
         r3_train["step_peak_bytes"], {"step_ms": r3_train["mean_ms"]})])
    emit({"phase": "tp_families", "path": "r",
          "seconds": time.perf_counter() - t0})
    return {k_: r1_launches[k_] + r3_launches[k_] for k_ in r1_launches}


# ---------------------------------------------------------------------------
# Path s: tensor-parallel compute over `model` for the SSM and hybrid
# ---------------------------------------------------------------------------

def ssm_tp_serve(torch, arm, arch, model, params, base, shape, placed=None,
                 init=None):
    """A served arm of path s: ``arch`` (bf16, full width and depth) over
    (data, model) = ``shape`` positions of the card, 4 × 4096 prompts
    prefilled once warm, then counted with ``SSM_TP_DECODE`` greedy steps
    (``mesh_serve_run``; ``placed`` parameters already laid out, else
    ``params`` laid out by the steps' shardings): ms beside the one-device
    path's line ``base``, each position's bytes, the peaks; one flash
    launch an application of attention a position in the prefill and none
    in decode; every position holding exactly its blocks of every
    parameter and cache leaf.  Returns (launches, the line)."""
    from repro_torch.models import zoo
    cfg = model.cfg
    n_rows, n_model = shape
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 19)
    B, S = LM_BATCH, LM_PROMPT
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    (sd, cache, outs, greedy, pre_s, dec_s, pre_peak, dec_peak,
     pre_launches), launches = counted(
        torch, arm, ("flash_attention",) if attention_apps(cfg) else (),
        lambda: mesh_serve_run(torch, model, params, toks,
                               S + SSM_TP_DECODE, SSM_TP_DECODE, shape,
                               placed=placed))
    apps = attention_apps(cfg) * n_rows * n_model
    held_p, off_p = held_bytes(sd)
    held_c, off_c = held_bytes(cache)
    dec_ms = dec_s * 1e3 / SSM_TP_DECODE
    line = {"phase": "main", "path": "s", "arm": arm, "arch": arch,
            "mesh": dict(zip(("data", "model"), shape)),
            "devices": f"[{DEVICE}:0] x {n_rows * n_model}",
            "tensor_parallel": True, "batch": B, "prompt": S,
            "decode_steps": SSM_TP_DECODE,
            "prefill_ms": pre_s * 1e3, "one_device_prefill_ms":
            base["prefill_ms"], "prefill_vs_one_device":
            pre_s * 1e3 / base["prefill_ms"],
            "decode_ms_per_step": dec_ms, "one_device_decode_ms_per_step":
            base["decode_ms_per_step"], "decode_vs_one_device":
            dec_ms / base["decode_ms_per_step"],
            "prefill_peak_bytes": pre_peak, "decode_peak_bytes": dec_peak,
            "prefill_peak_gib": pre_peak / 2**30,
            "decode_peak_gib": dec_peak / 2**30,
            "one_device_max_memory_gib": base["max_memory_gib"],
            "held_by_position": {str(p): held_p[p] + held_c[p]
                                 for p in held_p},
            "params_held_by_position": {str(p): v for p, v in held_p.items()},
            "cache_specs": {k: str(v.sharding.spec)
                            for k, v in zoo.flatten(cache) if k != "len"},
            "positions_off": (off_p + off_c)[:8],
            "flash_launches": launches["flash_attention"],
            "flash_launches_prefill": pre_launches,
            "greedy_tokens_row0": [int(g[0, 0]) for g in greedy],
            **(init or {})}
    emit(line)
    check(pre_launches == apps and launches["flash_attention"] == apps,
          f"{arm}: flash_attention launched {pre_launches} times in the "
          f"prefill and {launches['flash_attention']} in all, not {apps} "
          f"(an application of attention a position) and none in decode")
    check(not off_p and not off_c, f"{arm}: positions hold other than "
          f"their blocks {(off_p + off_c)[:8]}")
    check(all(bool(torch.isfinite(o.full()).all()) for o in outs),
          f"{arm}: a logit is not finite")
    del sd, cache, outs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, line


def hybrid_tp_serve(torch, n):
    """s1: zamba2-7b at full width and depth, bf16, over (data, model) =
    ``HYBRID_TP_MESH`` positions of the card — one copy of the weights
    laid out a layer at a time (``place_by_layer``; the init's transient
    printed), each position its 56 of the 112 SSM heads of every layer
    and 16 of the shared block's 32 attention heads — the flash kernel at
    a position's shape against its plain version, then path n's serving
    shape (``ssm_tp_serve``): 13 flash launches a position in the
    prefill, none in decode."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    cfg = get_config(HYBRID_ARCH)
    n_rows, n_model = HYBRID_TP_MESH
    kernel = flash_case(torch, LM_BATCH // n_rows, cfg.n_heads // n_model,
                        cfg.n_kv_heads // n_model, LM_PROMPT, cfg.hd,
                        SEED + 17)
    emit({"phase": "kernel", "path": "s", "arm": "s1", **kernel})
    check_flash_case("s1", kernel)
    model = steps.serving_model(cfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    mesh = shard_mesh(torch, HYBRID_TP_MESH, ("data", "model"))
    sp, init = place_by_layer(torch, model, mesh, gen)
    emit({"phase": "init", "path": "s", "arm": "s1", "arch": HYBRID_ARCH,
          **init})
    check(init["weight_copies"] < 1.01, f"s1: the positions hold "
          f"{init['weight_copies']} copies of the weights, not one")
    out = ssm_tp_serve(torch, "s1", HYBRID_ARCH, model, None, n,
                       HYBRID_TP_MESH, placed=sp,
                       init={k: init[k] for k in ("init_s", "weights_gib",
                                                  "init_transient_gib")})
    del sp
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mamba_tp_serve(torch, m):
    """s2: mamba2-1.3b at full width and depth, bf16 weights from seed
    2016, over (data, model) = ``SSM_TP_MESH`` positions, path m's serving
    shape (``ssm_tp_serve``): no flash launch (no attention)."""
    cfg, model, params, _, init = serve_init(torch, SSM_ARCH)
    out = ssm_tp_serve(torch, "s2", SSM_ARCH, model, params, m, SSM_TP_MESH,
                       init={k: init[k] for k in ("init_s", "weights_gib")})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_train_peak(torch, path, arm, model, params, batch, shape):
    """The train step (``build_train_step``: the sharded gradients and
    AdamW) over (data, model) = ``shape`` positions of the card, one warm
    step then one measured: its ms and its peak over what was resident
    before the parameters were laid out (the account's train cell)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.optim import adam
    mesh = shard_mesh(torch, shape, ("data", "model"))
    p_shapes, p_axes = model.abstract_params()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    sp = shd.place_tree(params, shd.tree_shardings(p_axes, p_shapes, mesh))
    opt = adam.init(sp)
    step = steps.build_train_step(model)
    sp, opt, _ = step(sp, opt, batch)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sp, opt, met = step(sp, opt, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - resident
    line = {"phase": "main", "path": path, "arm": arm,
            "arch": model.cfg.name, "n_layers": model.cfg.n_layers,
            "dtype": model.cfg.dtype,
            "mesh": dict(zip(("data", "model"), shape)),
            "batch": {k: list(v.shape) for k, v in batch.items()},
            "step_ms": ms, "loss": float(met["loss"]),
            "step_peak_bytes": peak, "step_peak_gib": peak / 2**30}
    emit(line)
    check(math.isfinite(line["loss"]), f"{arm}: the loss is not finite")
    del sp, opt
    gc.collect()
    torch.cuda.empty_cache()
    return line


def ssm_tp_checks(torch):
    """s3: mamba2-1.3b and zamba2-7b at full width, depths
    ``SSM_TP_CHECK_LAYERS``, float32 from seeds 2034 and 2035, over (data
    2, model 2), prompts of ``SSM_TP_PROMPT`` tokens (the scan's pad
    path): a train step against the unsharded one (``tp_grads_arm``: one
    gradient block a position, bit for bit run to run), a prefill and
    ``SSM_TP_DECODE`` greedy steps against each data row served alone
    (``tp_serve_f32_arm``), each within ``TP_TOL`` or, where the
    unsharded float32 step's own floor passes it (these random models at
    full width: up to 7.6e-5, ``examples/torch_ssm_tp_probe.py``),
    ``FLOOR_FACTOR`` × that floor; then zamba2's train step with AdamW
    measured for the account (``tp_train_peak``).  Returns that line."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    train = None
    for i, arch in enumerate((SSM_ARCH, HYBRID_ARCH)):
        cfg = dataclasses.replace(
            get_config(arch), n_layers=SSM_TP_CHECK_LAYERS[arch],
            dtype="float32", param_dtype="float32", grad_accum=1)
        model = zoo.build(cfg, DEVICE)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(SEED + 18 + i)
        params = model.init(gen)
        B, S = LM_BATCH, SSM_TP_PROMPT
        toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                             device=DEVICE, dtype=torch.int32)
        batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
        tp_grads_arm(torch, "s", f"s3-train-{cfg.family}", model, params,
                     batch, SSM_TP_MESH, floor=True)
        tp_serve_f32_arm(torch, "s", f"s3-serve-{cfg.family}", model, params,
                         {"tokens": toks[:, :S]}, SSM_TP_DECODE, SSM_TP_MESH,
                         floor=True)
        if cfg.family == "hybrid":
            train = tp_train_peak(torch, "s", "s3-train-step", model, params,
                                  batch, SSM_TP_MESH)
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    return train


def ssm_tp_path(torch, m, n):
    """Path s: the hybrid (s1) and the SSM (s2) served over positions,
    each computing its ``model`` share, their float32 checks (s3) and the
    account of s1's cells and s3's zamba2 train cell against the card
    (s4).  Returns the path's launches."""
    from repro_torch.configs.base import ShapeSpec
    t0 = time.perf_counter()
    s1_launches, s1 = hybrid_tp_serve(torch, n)
    s2_launches, _ = mamba_tp_serve(torch, m)
    train = ssm_tp_checks(torch)
    account_cells(torch, "s", "s4", HYBRID_ARCH, [
        ("s1-prefill", HYBRID_TP_MESH, 1,
         ShapeSpec("s1p", LM_PROMPT, LM_BATCH, "prefill"),
         s1["prefill_peak_bytes"], {"prefill_ms": s1["prefill_ms"]}),
        ("s1-decode", HYBRID_TP_MESH, 1,
         ShapeSpec("s1d", LM_PROMPT + SSM_TP_DECODE, LM_BATCH, "decode"),
         s1["decode_peak_bytes"],
         {"decode_ms_per_step": s1["decode_ms_per_step"]})])
    account_cells(torch, "s", "s4", HYBRID_ARCH, [
        ("s3-train", SSM_TP_MESH, 1,
         ShapeSpec("s3t", SSM_TP_PROMPT, LM_BATCH, "train"),
         train["step_peak_bytes"], {"step_ms": train["step_ms"]})],
        over=dict(n_layers=SSM_TP_CHECK_LAYERS[HYBRID_ARCH],
                  dtype="float32", param_dtype="float32"))
    emit({"phase": "ssm_tp", "path": "s",
          "seconds": time.perf_counter() - t0})
    return {k_: s1_launches[k_] + s2_launches[k_] for k_ in s1_launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    src = REPO / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import fm
    from repro_torch.kernels import build
    fm.set_conf(device="cuda")
    t_start = t0 = time.perf_counter()
    build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(build.SOURCES), "tf32": False})

    x, y, xk, lab = make_data(torch)
    emit({"phase": "data", "shape": [N_ROWS, N_COLS], "dtype": "float32",
          "gib": x.numel() * 4 / 2**30, "seed": SEED})
    rows = kernel_phase(torch, x, xk)
    small_phase(x, xk, lab)
    launches_a, res_a = main_phase(torch, x, y, xk)
    explain_phase(torch, x, y, xk)
    res_a["kmeans"].labels = None    # path e compares centers and wss
    paths = [launches_a, algorithms_phase(torch, x, xk, lab)]
    paths += ooc_phase(torch, x, y, xk, res_a)
    del res_a
    stress_phase(torch)
    from repro_torch.core import materialize
    materialize.clear_plan_cache()   # cached plans hold their sources
    del x, y, xk, lab
    gc.collect()                     # reference cycles in the engine hold them
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cols, vals, ys = make_criteo(torch)
    emit({"phase": "data", "shape": [CRITEO_ROWS, CRITEO_FACTORS],
          "ncol": CRITEO_FACTORS * CRITEO_BUCKETS, "zipf_s": ZIPF_S,
          "slab_gib": (cols.nbytes + vals.nbytes) / 2**30, "seed": SEED,
          "seconds": time.perf_counter() - t0})
    rows += spmm_rows(torch, cols, vals)
    paths.append(sparse_phase(torch, cols, vals, ys))
    materialize.clear_plan_cache()   # cached plans hold the slab
    del cols, vals, ys
    gc.collect()
    torch.cuda.empty_cache()

    rows.append(flash_row(torch))
    lm_launches, lm_line = lm_phase(torch, rows[-1]["ms"])
    paths.append(lm_launches)
    gc.collect()
    torch.cuda.empty_cache()
    j2 = train_path(torch)
    gc.collect()
    torch.cuda.empty_cache()
    k_launches, k_line = moe_phase(torch)
    paths.append(k_launches)
    gc.collect()
    torch.cuda.empty_cache()
    paths.append(vlm_phase(torch))
    gc.collect()
    torch.cuda.empty_cache()
    m_launches, m_line = ssm_phase(torch)
    paths.append(m_launches)
    gc.collect()
    torch.cuda.empty_cache()
    n_launches, n_line = hybrid_phase(torch)
    paths.append(n_launches)
    gc.collect()
    torch.cuda.empty_cache()
    o_launches, o_line = encdec_phase(torch)
    paths.append(o_launches)
    gc.collect()
    torch.cuda.empty_cache()
    p0, p1 = shard_path(torch, j2)
    gc.collect()
    torch.cuda.empty_cache()
    paths.append(mesh_serve_path(torch, lm_line, p0, p1))
    gc.collect()
    torch.cuda.empty_cache()
    paths.append(tp_families_path(torch, k_line, o_line))
    gc.collect()
    torch.cuda.empty_cache()
    paths.append(ssm_tp_path(torch, m_line, n_line))
    for r in rows:
        r["launches"] = sum(p[r["name"]] for p in paths)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (CheckFailed, AssertionError) as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
