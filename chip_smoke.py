#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card and check them.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which asserts:
1. device: a CUDA card is present; print its name and power limit;
2. build: compile every CUDA kernel of the path from ``ray_tpu_torch/ops/csrc``
   and print ptxas's registers and spills for each instantiation; no bf16
   forward spills;
3. kernels: hold the flash-attention forward kernels (f32: FMA; bf16:
   tensor cores) against their plain PyTorch version (O and LSE) over head
   dims 16/32/64/128, f32 and bf16, causal and full, L = 256, 1024 and a
   ragged 200, and Lq != Lk; bf16 at the training cells' head count and
   width (32 heads of 128) too;
4. entry: run ``ray_tpu_torch.entry``'s flagship forward once;
5. serve: answer 16 requests of 1..1024 tokens through ``@serve.batch`` and
   a ``TorchPredictor`` at the width of ``bench.py``'s transformer (d_model
   1024, 12 layers, 16 heads, d_ff 4096, vocab 32000; ~268 M parameters,
   random weights from a seed). In f32 each answer must match a one-request,
   unpadded run of the dense-attention model; in bf16 answers must be
   finite. Every attention call must have gone through the kernel;
6. times: the kernel, its plain version and PyTorch's
   ``scaled_dot_product_attention`` at the serving shape, beside the
   kernel's bound, and the bf16 serving rate; then the kernel at the
   training cells' attention shapes (B=2, H=32, D=128, causal, L=4097 and
   16385), held against the plain version and timed beside SDPA and the
   bound that ``perfbench/core/work.py`` counts;
7. backward kernels: dQ, dK and dV of the dq and dkv kernels (f32: FMA;
   bf16: both on the tensor cores) against the plain backward over the
   cases of phase 3, and the same cases through the autograd Function
   against autograd of the plain forward;
8. training parity: 3 f32 steps of ``make_lm_train_step`` at the width of
   phase 5 cut to 2 layers, batch 2 x 513 tokens, through the kernels and
   through dense attention from the same weights; loss and grad norm agree
   step by step;
9. training (the kernels line's launches are counted here): the
   transformer of phase 5 at full depth, bf16, remat on, default AdamW,
   batch 8 x 1025 tokens: 1 warm-up step and 5 measured steps on one seeded
   batch; losses finite and falling, 2 x n_layers forward and n_layers dq
   and dkv launches a step, and one AdamW launch (``ops/adamw.py``, a
   launch a table of leaves; also checked in phases 17 (a) and 19 (a));
   step time, tokens/s, peak memory; a
   ``torch.profiler`` trace of 3 steps: the device's busy share and the
   operators that take its time;
10. backward times: each backward kernel, the plain backward and PyTorch's
   SDPA backward at the training shape, beside each kernel's bound, and the
   attention kernels' share of a training step;
11. ResNet parity: ``resnet18(num_classes=10)`` in f32 (TF32 off), batch 4
   at 64 x 64 and 37 x 37, from the same weights on the card and on the
   CPU: logits, loss and every gradient agree (the CPU tests hold the CPU
   run against the JAX package);
12. ResNet training (the image path; no attention kernel on it, so the
   launch counts stay 0): ResNet-50 at batch 128 x 224 x 224 and ResNet-18
   at batch 256, bf16, SGD(0.1, momentum 0.9), one seeded batch: 1 warm-up
   step, in which every convolution's tensors must be ``channels_last``,
   then 10 measured steps; losses finite, and the first update lowers the
   loss (the recipe overshoots later on this batch); step time, images/s,
   model TFLOP/s and MFU (``bench.py``'s FLOP count), peak memory, and a
   trace as in phase 9;
13. bench: ``python3 -m ray_tpu_torch.bench`` as a user runs it, in a
   subprocess; it exits 0, its headline has every device figure (PPO's
   env-steps/s with the learner on the card among them) and no error, and
   its transformer section launched the three
   kernels 2 x n_layers / n_layers / n_layers times a step;
14. sharded step (``ray_tpu_torch.parallel``): (a) ``dryrun_multichip`` over
   every card of the machine on NCCL, one rank per card; (b) in this
   process, an NCCL world of one rank and a mesh whose every axis is 1: 3 f32
   steps of the sharded ``make_lm_train_step`` at phase 8's width, batch
   and weights follow phase 8's one-device trajectory through the kernels
   (loss and grad norm at ``TRAIN_RTOL``); (c) phase 9's bf16 training
   (same width, depth, batch and weights) through the sharded step: 1
   warm-up and 5 measured steps, losses finite and falling, 2 x n_layers /
   n_layers / n_layers kernel launches a step, and the step time beside
   phase 9's (the cost of the DTensor path at world size 1); (d) the
   one-device and the sharded step timed in turns in this process;
15. runtime (``ray_tpu_torch``'s in-process runtime): (a) ``init(num_cpus=8)``
   detects the card as ``GPU: 1.0``; whether the native object arena and
   scheduling library loaded; (b) a bf16 [8192, 8192] tensor produced on a
   side stream (behind ~50 ms of spinning) and ``put``: ``get`` from another
   task returns the same object, device memory is unchanged, and its values
   equal a host-synchronised copy (the put's event was waited on); an
   in-place write makes ``get`` refuse it; the put/get round trip (host
   clock, median of 100); (c) phase 5's deployment, weights and requests in
   a ``num_gpus=1`` actor granted ``[cuda:0]``: f32 answers against the
   dense run as in phase 5, then bf16 (1 warm-up and 3 measured passes),
   ``n_layers`` forward launches per batch, requests/s beside phase 5's;
   (d) a ``num_gpus=1`` task over a CUDA tensor (as an ObjectRef and as an
   argument: same ``data_ptr``) returns the product on the card, and a
   request for more GPUs than the node has is infeasible; (e) ``shutdown``
   and a second ``init`` in the same process;
16. Serve plane (``ray_tpu_torch.serve``: controller, replicas, router,
   handles, HTTP proxy) on ``init(num_cpus=8)``: phase 5's weights and
   requests, served by one deployment whose replicas batch requests
   themselves (``max_batch_size=8``, ``pad_batch_to`` the batch buckets):
   (a) ``serve.run`` with ``ray_actor_options={"num_gpus": 1}``, f32, the 16
   requests from 16 threads through ``handle.remote(r).result()``: the
   replica was granted ``[cuda:0]``, answers match the dense run at 1e-3,
   ``n_layers`` forward launches per batch; (c) ``start_http_proxy``: the
   same requests POSTed as JSON token lists, each answer the JSON logit row,
   checked the same way; ``/-/healthz`` 200, ``/-/routes`` lists the route,
   an unknown route 404; (b) a rolling update to bf16: 1 warm-up and 3
   measured passes by handle from 16 threads, then 3 from one thread (as
   phase 15 submits), answers finite, requests/s beside phases 5 and 15,
   with the replica's batch sizes and the seconds it spent answering; (d)
   a rolling update to two ``num_gpus=0.5`` replicas (granted no device,
   user code on ``cuda``) answering the replica's tag and the row as a CUDA
   tensor: both replicas serve; (e) ``serve.shutdown`` and
   ``shutdown``: no serve thread left, and device memory back within 1 MiB
   of its value before the phase. Each ``serve.run``'s seconds and each
   sub-phase's are printed;
17. training plane (``ray_tpu_torch.train.TorchTrainer`` on
   ``init(num_cpus=8)``): (a) phase 9's model, weights and batch in one
   ``use_gpu`` worker on the ``nccl`` group, whose loop builds
   ``make_lm_train_step`` on ``session.get_mesh()`` (a ``data=1`` mesh over
   a world of one) and feeds ``session.shard_batch``: 1 + 2 steps, each
   reported, the third with the full f32 state (parameters and AdamW
   moments, 3.2 GB) checkpointed into the git-ignored build/trainer (the
   free space is checked first, and the directory deleted at the end);
   losses finite and falling, 2 x n_layers / n_layers /
   n_layers launches every step, the committed state restored byte for
   byte against the host copy of its step; the trainer's step beside
   phase 9's, ``session.report`` ms, the checkpoint's enqueue ms, commit
   s, bytes and restore s, and the goodput ledger; (b) phase 8's model and
   batch, a checkpoint every step, the first attempt raising after step
   3: the restart resumes from the last commit (AdamW step restored, the
   step count carried, restart downtime accounted), steps 4-6 match an
   uninterrupted run at ``TRAIN_RTOL``, and device memory after ``fit``
   equals its value before; (c) two ``num_gpus=0.5`` workers on half of
   phase 8's batch each, allreducing gradients over the ``nccl`` group
   folded onto the card: the trajectory matches phase 8's at
   ``TRAIN_RTOL``, each result a new CUDA tensor of the input's dtype;
   allreduce and step ms; (d) the ``nccl`` group over distinct cards,
   which needs two or more (with one, the phase says it did not run);
18. multi-process runtime (``ray_tpu_torch.cluster_utils.ProcessCluster``:
   the port's Python state service and host-daemon processes): (a) a
   cluster of one CPU daemon (``num_cpus=4``) plus ``add_daemon(num_gpus=1)``
   and ``init(address=cluster.address)``: ``GPU: 1.0`` in
   ``cluster_resources()``; a ``num_gpus=1`` task runs in another process
   whose ``CUDA_VISIBLE_DEVICES`` names the card; the seconds until each
   daemon registered; (b) a seeded bf16 [8192, 8192] tensor made in the
   daemon reaches the driver on its own ``cuda:0`` bit-equal to the same
   seeded build in the driver, a driver ``put`` reaches a daemon task
   bit-equal, a put tensor written in place is refused across processes;
   bytes and host-clock ms of each hop (median of 5); (c) phase 5's
   deployment in a ``num_gpus=1`` actor inside the daemon: the weights
   ``put`` by the driver as host numpy (f32, ~1.07 GB) and fetched by the
   actor (bytes and seconds); f32 answers to phase 5's 16 requests against
   the dense run at 1e-3; a switch to bf16, 1 warm-up and 3 measured passes
   from 16 threads and 3 from one, answers finite; requests/s beside phases
   5, 15 and 16; the actor's own forward launch count (``n_layers`` per
   batch, in the daemon's process) goes into the kernels line; (d)
   ``kill_daemon`` of the GPU daemon: a call on the actor raises
   ``ActorDiedError`` within the heartbeat timeout, the node is dead in the
   state service, the card's free memory returns to within 64 MiB of its
   value before (a), and a new ``add_daemon(num_gpus=1)`` takes the card
   back and a fresh actor there answers one f32 batch correctly; (e)
   ``shutdown()`` and ``cluster.shutdown()``: no daemon or state-service
   process is left;
19. tensor plane (``collective/tensor_plane.py`` and ``NCCLProcessGroup``:
   collective groups whose ranks are daemon processes): (a) a
   ``ProcessCluster`` of one CPU daemon plus ``add_daemon(num_gpus=1)``,
   ``init(address=)``, and ``TorchTrainer(num_workers=1, use_gpu=True)``
   on the default ``nccl`` backend: its worker, in the GPU daemon, joins
   the plane (world 1, NCCL, coordinator read from the state-service KV)
   and gets the ``data=1`` mesh over it; phase 9's model from phase 9's
   seed, 1 + 5 steps, each reported; step 0's loss equals phase 9's first
   at ``TRAIN_RTOL``, losses finite and falling, 2 x n_layers / n_layers /
   n_layers launches a step counted in the daemon's process (into the
   kernels line); the last step reports the parameters (f32, ~1.07 GB),
   which the engine commits under the git-ignored build/plane; the step's
   ms beside phases 9 and 17 (a), the report's ms, the commit's seconds;
   then ``TorchTrainer(datasets={"train": ds})`` with one ``use_gpu``
   worker in the GPU daemon, ``ds`` 2 int32 blocks of phase 9's batch
   shape (block 0 phase 9's batch) put by the driver and fetched by the
   daemon, read through ``iter_device_batches`` (phase 20 (b)'s loop): 2
   steps, every batch a CUDA DTensor equal to its block, step 0's loss
   equal to phase 9's at ``TRAIN_RTOL``, its launches counted in the
   daemon (into the kernels line);
   (b) ``serve.run`` of a ``num_gpus=1`` deployment in the GPU daemon from
   the dict form of (a)'s ``CheckpointRef``: f32 answers to phase 5's
   requests match a dense forward here on the same checkpoint at 1e-3;
   then a bf16 deployment from it, 1 warm-up and 3 measured passes from 16
   threads and 3 from one, requests/s beside phases 16 and 18 (c), the
   replica's forward launches counted in the daemon (into the kernels
   line); (c) a gloo plane over two CPU daemons: allreduce, reduce,
   broadcast, allgather, reducescatter and barrier on seeded tensors
   against numpy, an 8 MB bulk-lane send each way bit-equal, nothing of
   the group left under the p2p namespace of the KV, each op's ms; (d) an
   NCCL plane over two GPU daemons on distinct cards, which needs two or
   more (with one, the phase says it did not run); (e) ``serve.shutdown``,
   ``shutdown`` and ``cluster.shutdown``: no process left, the card's free
   memory back within 64 MiB of its value before (a), the checkpoint
   directory deleted;
20. data plane (``ray_tpu_torch.data`` on ``init(num_cpus=8)``): (a) 64
   seeded rows of phase 5's kind (lengths 1..1024, right-padded to 1024,
   with a ``length`` column) as a tabular dataset of 8 blocks (a
   ``tokens`` column of arrays), through ``BatchPredictor`` and a
   ``TorchPredictor`` at phase 5's width, batches of 8, keeping
   ``length``: in f32 the first 16 rows' logits at ``length - 1`` match an
   unpadded dense run at 1e-3, then 1 warm-up and 3 measured bf16 runs,
   all 64 rows finite; the predictor built once per run, n_layers forward
   launches per batch; rows/s and real tokens/s beside phase 5's; (b)
   ``TorchTrainer(datasets={"train": ds})``, one ``use_gpu`` worker:
   phase 9's model and seed, ``ds`` 6 blocks of phase 9's batch shape
   (int32, block 0 phase 9's batch); the loop reads
   ``get_dataset_shard("train").iter_device_batches(sharding=(mesh,
   batch_sharding(mesh)), prefetch_batches=2)``: every batch a CUDA
   ``DTensor`` whose local tensor equals its block, 1 + 5 steps, step 0's
   loss equal to phase 9's at ``TRAIN_RTOL``, losses finite, 2 x n_layers /
   n_layers / n_layers launches a step; the step's ms beside phases 9 and
   17 (a), the goodput ledger's ``data_wait`` share, one batch's pin and
   copy on the host clock; (c) ``shutdown``: the card's free memory back
   within 64 MiB of its value before (a), measured after 12 new threads'
   first matmuls (whose cuBLAS handles, which PyTorch pools for the life
   of the process, (a) and (b) would otherwise make) and printed with
   what those took;
21. RL (``ray_tpu_torch.rl`` PPO, ``ray_tpu_torch.tune``): the fcnet
   actor-critic (64, 64) on CartPole-v1 at ``tests/test_rl.py``'s PPO
   gate config (8 envs x 100 steps, train batch 800, minibatch 256, 8
   SGD passes), rollouts on the CPU: (1) one ``PPOLearner.sgd`` on the card
   against the CPU learner, the same weights, batch and permutations, at
   ``RL_RTOL``/``RL_ATOL``, the largest differences printed; (2)
   ``build().train()`` for 25 iterations with the learner on the card,
   passing the gate (final ``episode_reward_mean`` > max(80, 2 x first)),
   env-steps/s, sample and learn ms an iteration, and the same with the
   learner on the CPU beside them; (3) ``tune.run`` of a PPO subclass with
   ``resources_per_trial={"cpu": 1, "gpu": 1}`` on ``init()``, 2
   iterations, the trial's learner tensors on ``cuda:0``; (4) 2 remote
   rollout workers (CPU actors) under ``init()``, 2 iterations; (5) the
   card's free memory back within 64 MiB of its value before (1), and the
   flash kernels' launch counters unmoved (no kernel of the repo is on
   this path);
22. RL, the slice's other learners (``ray_tpu_torch.rl``: the memory models
   for PPO and IMPALA, IMPALA/APPO, DQN, SAC, TD3, DDPG), rollouts on the
   CPU: (1) one update of each learner on the card against the same
   learner on the CPU, the same carried weights, batch and fed
   permutations or noise, at ``RL_RTOL``/``RL_ATOL``, at full width
   (``RecurrentPPOLearner`` with an LSTM of 64 and with attention 64 /
   window 8 (the gate's schedule of 40 minibatch steps); ``ImpalaLearner``
   under RMSprop, APPO's clip and with an LSTM of 64; ``DQNLearner`` with
   double Q; ``SACLearner`` and a ``TD3Learner`` critic-only step and
   actor step at fcnet (256, 256)), the largest differences printed, then
   each card learner alone for 40 optimizer steps (host ms a step); (2)
   the learning gates of ``tests/test_rl.py`` and
   ``tests/test_rl_extended.py`` (configs, iterations and thresholds
   unchanged; LSTM and attention PPO on MemoryCue, LSTM IMPALA, APPO with
   2 remote workers, DQN, SAC, TD3, DDPG) through ``build().train()``
   with the learner on the card, 4 at a time, each in a spawned process
   (run one after another they take ~11 minutes), each with its
   env-steps/s, learner updates/s and sample and learn ms an iteration;
   (3) a ``torch.profiler`` window over 100 SAC updates: the device's
   busy share and kernel launches an update; (4) the card's free memory
   back within 64 MiB of its value before (1) (the process's one-time
   costs are paid before it and their bytes printed: the first cuBLAS
   handles of new threads, the profiler's first session, and the code of
   the learners' kernels, which CUDA loads at a kernel's first launch and
   keeps: one update of each learner on the card), and the flash kernels'
   launch counters unmoved;
23. RL, the multi-learner slice (``ray_tpu_torch.rl``: the PPO learner over
   a mesh, DD-PPO, multi-agent PPO, QMIX, BC, MARWIL, CQL), rollouts on the
   CPU: (1) one update of each on the card against the same learner on the
   CPU, the same weights, batch and fed permutations, at
   ``RL_RTOL``/``RL_ATOL`` (phase 21's PPO schedule by the learner over a
   ``data=1`` mesh of an NCCL world of one, held also bit for bit
   (``torch.equal``) against the one-device learner on the card; a DD-PPO step of the gate's two workers,
   each on its own thread and 400-step batch; ``QMIXLearner`` on 128
   replayed joint transitions; the BC, MARWIL and CQL steps at their gates'
   shapes), the largest differences printed, then each card learner alone
   for 40 optimizer steps (host ms a step); (2) the reference's gates
   (configs, iterations and thresholds unchanged: multi-agent PPO on the
   coordination game, BC, CQL, MARWIL against BC, QMIX on the two-step game
   from the JAX package's seed-0 parameters in ``tests/data/``, DD-PPO on
   CartPole with its workers bit-identical after) through
   ``build().train()`` with the learners on the card, 4 at a time, each in
   a spawned process, with env-steps/s or updates/s and host ms an update;
   (3) DD-PPO with ``collective_backend="nccl"``, both workers folded on the
   card, 2 iterations: lockstep, and the allreduce's host ms; (4) the
   card's free memory back within 64 MiB of its value before (1) (each case
   run once on the card before the baseline, and what that took printed),
   and the flash kernels' launch counters unmoved;
24. the leaf libraries and the autoscaler, each driving phase 5's model
   (f32, weights from its seed) on the card; an answer is the argmax of a
   request's last-token logits, the request alone at its length bucket, and
   each must equal the direct answers made here (the kernels line counts
   every forward launch, in whichever process it ran): (a) ``workflow``: pad
   on the host, a ``num_gpus=1`` step that builds the model and returns the
   answers as a CUDA tensor, and a reducer that fails on its first run: the
   run ends FAILED, ``resume`` answers without a forward launch, and
   ``get_output`` in a process with ``CUDA_VISIBLE_DEVICES=""`` returns the
   same values as a CPU tensor; (c) ``Pool(2, ray_remote_args={"num_gpus":
   0.5}).map`` and, where ``joblib`` imports, its backend; (b) a
   ``ClientServer`` here and a Ray Client in a process without a card that
   makes a ``num_gpus=1`` actor holding a ``TorchPredictor``: the requests
   from 1 thread and from 4, each answer a CPU tensor, requests/s beside
   the direct rates; (e) while that actor lives, ``list_actors`` and
   ``list_nodes`` show it and its node's GPU granted, and
   ``summarize_tasks`` counted (c)'s tasks; (d) ``JobManager``: a job
   running ``entry()``'s forward logs a checksum equal to this process's,
   and a job holding 1 GiB of the card ends STOPPED by ``stop_job`` with the
   card's free memory back within 64 MiB; (f) a ``StandardAutoscaler`` over
   a ``ProcessCluster`` whose daemon owns no card: a ``num_gpus=1`` task
   makes ``update()`` start a GPU daemon, the task's answers come back
   equal, and once idle the daemon is terminated and the card's memory
   comes back; seconds from the demand to the daemon registered, to the
   answer and to the scale-down;
25. the cluster tools around phase 5's model (f32, weights from its seed):
   (a) ``python -m ray_tpu_torch.scripts.cluster start --head
   --num-gpus=0 --num-cpus=0`` and ``start --address=<head> --num-gpus=1
   --num-cpus=8`` with the head's token, each in its own run dir under
   ``build/cli`` (the head boots while this process makes the
   references); ``status`` lists both daemons alive and 1 GPU; a driver
   ``init(address=, auth_token=, num_cpus=1, include_dashboard=True)``
   (its CPU hosts the Serve controller) whose ``/api/cluster`` lists the
   GPU node;
   (b) with ``autopilot_enabled``, a batched deployment (``max_batch_size``
   8, a linger of 200 ms) on a ``num_gpus=1`` replica in the GPU daemon,
   the Serve controller in the driver: 16 requests one at a time, then
   ``poke()``: the journal shows an applied halving of
   ``serve.lm25.linger_ms`` with the daemon's queue wait p95 as its
   evidence, and 16 more requests wait less; every answer matches the
   dense run at rtol = atol = 1e-3 and equals the direct forward bit for
   bit; ``python -m ray_tpu_torch.doctor --address --explain`` prints the
   decision; (c) ``python -m ray_tpu_torch.scripts.cli top --json
   --subsystem serve`` shows the daemon's ``serve.*`` rows; (d) a task held
   in flight on the GPU daemon by a chaos delay, the daemon SIGKILLed: the
   doctor reads the crash, the task and its trace id from the flight dir,
   and the card's free memory is back within 64 MiB in under 10 s; (e)
   ``shutdown()`` and ``stop`` on both run dirs leave no process;
26. the devtools on the card: (a) a process started with
   ``RAY_TPU_LOCKWATCH=1`` (the lock-order watchdog wraps every lock the
   package creates) serves phase 16's batched bf16 deployment
   (``num_gpus=1``) phase 5's 16 requests from 16 threads, 1 + 3 passes,
   then one ``use_gpu`` ``TorchTrainer`` worker takes 2 steps of phase 8's
   model, whose (loss, grad norm) follow phase 8's at ``TRAIN_RTOL``; its
   JSON report must hold zero cycles and zero guard violations, its
   launches go into the kernels line, and its requests/s is printed beside
   phase 16's (the watchdog's cost); (b) a guard-band check of the forward,
   dq and dkv kernels in both dtypes (``fwd_bf16_kernel``/``fwd_kernel``,
   ``dq_*``, ``dkv_*``), the stand-in for compute-sanitizer, which does
   not run on that machine: D 16/32/64/128, causal and full, L 200
   (ragged) and 1024 and Lq 200 / Lk 333, one head, every input and
   output the middle of a larger buffer whose bands hold 0 in one run and
   NaN in another; the outputs must be bit-identical between the runs and
   every band unchanged bit for bit (a read past a tensor shows as a
   difference, a write past it as a changed band); then 4 heads of 2
   batches at once must equal each head run alone, bit for bit. Its
   launches compare and do not count;
27. a C++ driver (``ray_tpu_torch/_native/cpp_serve_lm.cc``, a user program
   that includes the port's ``cpp_worker.cc``; g++ alone, no protobuf
   library, built in a process of its own from phase 2's end on) on phase
   25's cluster, between its (c) and (d): Python registers ``ServingLM``
   (phase 5's f32 model from its seed on ``resolve_device()``'s card) by
   name, and the program makes it with ``Actor("ServingLM").Remote()``,
   then sends phase 5's 16 requests one at a time and then all 16 as
   ``ObjectRef`` futures in flight; every answer must equal phase 24's
   direct answer, the actor must have run on the card in the GPU daemon
   with ``n_layers`` forward launches a request there (into the kernels
   line), the demo driver's checks (nodes, KV, ``cpp_add``, the typed
   ``Counter``) must pass on the same cluster, ``Kill()`` must end the
   actor, and ``ldd`` must name no ``libprotobuf``; the build's seconds,
   the C++ requests/s both ways beside phase 24's direct and Ray Client
   rates, and the mean JSON bytes of a request and an answer.

28. the one-pass AdamW kernel (``ray_tpu_torch/ops/csrc/adamw.cu``), run
   after phase 10, at each training cell's f32 leaf set (2.458 B, 2.433 B
   and 2.013 B parameters; ``perfbench/configs/``): one launch steps every
   leaf, each leaf's param and moments equal ``adamw_reference``'s at rtol
   1e-6 and its sum of g*g equals ``g.square().sum()``; its time
   beside its bound (28 bytes a parameter at 3.35 TB/s), the plain
   version's, the parent step's optimizer phase (the norm's own pass and
   ``torch.optim.AdamW``'s foreach passes) and ``torch.optim.AdamW(fused=
   True)`` as ``library_ms`` (the port never calls it); and the memory
   each adds past the state it steps. Alone: ``python3 -c "import torch,
   chip_smoke as cs; cs.adamw_phase(torch.device('cuda'),
   cs.card_line())"``.

Kernel times (phases 6, 10 and 28) are device times: ``time_ms`` enqueues n
calls back to back between two CUDA events and divides, so a kernel is not
charged its wrapper's host path.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import math
import pathlib
import re
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

SEED = 0
N_REQUESTS = 16
SERVE_RUNS = 3       # measured bf16 passes over the requests
LENGTH_BUCKETS = (128, 256, 512, 1024)
BATCH_BUCKETS = (1, 2, 4, 8)
# The transformer of bench.py:141-145, the widest the repository runs.
SERVE_WIDTH = dict(vocab_size=32000, d_model=1024, n_layers=12, n_heads=16,
                   d_ff=4096, max_seq_len=1024)
# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The bf16 forward over a whole launch (tests/test_torch_kernels.py): the
# largest |LSE error| and the relative L2 error of O.
BF16_LSE_ATOL = 1e-4
BF16_O_REL_L2 = 1e-2
# The training cells' attention forward, as ``perfbench/configs/`` sizes it:
# (cell, B, L, heads, KV heads, head dim). K and V reach the kernel
# repeated to every head.
FWD_CELL_SHAPES = (("deepseek7b.train.s4k", 2, 4097, 32, 32, 128),
                   ("mistral7b.train.s16k", 2, 16385, 32, 8, 128))
# Phase 28: the training cells' f32 leaf sets, as ``perfbench/configs/``
# sizes them: (cell, config). The AdamW pass's bound moves 28 bytes a
# parameter: p, g, m and v read, p, m and v written.
ADAMW_CELLS = (("deepseek7b.train.s4k", "deepseek-llm-7b.stage8"),
               ("deepseekmoe16b.train.s4k", "deepseek-moe-16b.stage14.ep4"),
               ("mistral7b.train.s16k", "mistral-7b-v0.3.stage8"))
ADAMW_BYTES_PER_PARAM = 28
# Gradients: f32 at the reference's grad tolerance (tests/test_ops.py). bf16
# at GRAD_REL_BF16 of the largest |grad| in the case: kernel and plain
# version compute in f32 from the same bf16 inputs and round each gradient
# once to bf16, so they differ by about one bf16 step (2^-7 relative) of the
# largest value, plus f32 summation order.
GRAD_TOL_F32 = 2e-4
GRAD_REL_BF16 = 1e-2
# Training: phase 8 cuts SERVE_WIDTH to 2 layers; phase 9 runs it in full.
PARITY_WIDTH = dict(SERVE_WIDTH, n_layers=2)
PARITY_BATCH = (2, 513)
PARITY_STEPS = 3
TRAIN_RTOL = 1e-4
TRAIN_BATCH = (8, 1025)
TRAIN_STEPS = 5      # measured, after one warm-up step
# Phase 17 (a): TorchTrainer's steps after the warm-up one; the state is
# committed at the third report (3.2 GB), so a run of 1 + 2 steps makes one
# commit where 1 + 5 made two.
TRAINER_STEPS = 2
STEP_PAIRS = 5       # phase 14 (d): rounds of the two step paths in turns
# ResNet: phase 11 (f32 parity, card vs CPU) and phase 12 (bf16 training).
RESNET_PARITY_SIDES = (64, 37)
RESNET_PARITY_BATCH = 4
# f32 with TF32 off: cuDNN and the CPU sum in other orders, and batch norm
# divides by small standard deviations, so each value is held at
# RESNET_RTOL of itself plus RESNET_RTOL of its tensor's largest |value|.
RESNET_RTOL = 1e-3
RESNET_TRAIN = (("resnet50", 128), ("resnet18", 256))
RESNET_STEPS = 10    # measured, after one warm-up step
BENCH_TIMEOUT_S = 600
# Phase 15: the in-process runtime. A bf16 [8192, 8192] device object, put
# while its product is still queued behind SIDE_STREAM_SLEEP_CYCLES (~50 ms
# at the H100's boost clock) of spinning on a side stream; its put/get round
# trip timed PUT_GET_RUNS times. Runtime files go under the git-ignored
# build/ rather than the temporary directory.
OBJECT_SIDE = 8192
SIDE_STREAM_SLEEP_CYCLES = 100_000_000
PUT_GET_RUNS = 100
RUNTIME_CONFIG = {"flight_recorder_dir": "build/runtime/flight",
                  "object_spilling_dir": "build/runtime/spill"}
# Phase 16: the Serve plane. Every deployment holds a latency budget far
# above an f32 batch's time: at the default 100 ms the replica batcher would
# cap f32 batches below max_batch_size and the router would shed.
SERVE_ROUTE = "/lm"
SERVE_BUDGET_MS = 10_000.0
SERVE_MEMORY_SLACK = 2**20
# Phase 17: TorchTrainer. Its checkpoints go under the git-ignored build/
# and are deleted at the end; a fit() that blocks longer than this fails.
TRAINER_DIR = "build/trainer"
TRAINER_TIMEOUT_S = 600
# Phase 18: the multi-process runtime. A bf16 [OBJECT_SIDE]^2 tensor crosses
# processes each way HOP_RUNS times; after the GPU daemon is killed the
# card's free memory must come back to within PROCESS_MEMORY_SLACK of its
# value before the phase.
HOP_RUNS = 5
PROCESS_MEMORY_SLACK = 64 * 2**20
# Phase 19: the tensor plane. The trainer's checkpoint goes under the
# git-ignored build/ and is deleted at the end; each bulk-lane send of (c)
# is this many f32 values (8 MB). The state service's own default heartbeat
# timeout: the GPU daemon pickles the 1.07 GB reported checkpoint for the
# driver on its interpreter lock, which starves its heartbeat thread for
# about as long as ProcessCluster's 3 s test timeout.
PLANE_DIR = "build/plane"
PLANE_BULK_ELEMS = 2 * 1024 * 1024
PLANE_HEARTBEAT_TIMEOUT_MS = 10_000
PLANE_DATASET_STEPS = 2   # phase 19 (a): steps fed by a dataset
# Phase 20: the data plane. DATA_ROWS rows over DATA_BLOCKS blocks, read in
# batches of DATA_BATCH; the first DATA_CHECKED f32 rows against dense.
DATA_ROWS = 64
DATA_BLOCKS = 8
DATA_BATCH = 8
DATA_CHECKED = 16
COPY_RUNS = 20
# Phase 21: PPO at tests/test_rl.py:197-218's gate, learner on the card.
RL_ITERS = 25
RL_TUNE_ITERS = 2    # (3) the trial's and (4) the remote workers' iterations
RL_RTOL, RL_ATOL = 1e-4, 1e-6   # (1) the card's learner against the CPU's
# Phase 22: the other single-learner algorithms, at their tests' gates.
RL_TIMED_STEPS = 40        # (1) optimizer steps of each learner, timed
RL_PROFILE_UPDATES = 100   # (3) SAC updates under the profiler
RL_GATE_PROCESSES = 4      # (2) gates run at once, a process each
# Phase 23: the multi-learner slice (mesh PPO, DD-PPO, multi-agent PPO,
# QMIX, BC, MARWIL, CQL), at the tests' gates.
DDPPO_NCCL_ITERS = 2       # (3) DD-PPO iterations over the nccl backend
REPO = pathlib.Path(__file__).resolve().parent
# (2) QMIX's gate starts from the JAX package's seed-0 parameters
QMIX_JAX_INIT = REPO / "tests" / "data" / "qmix_two_step_jax_init.npz"
# Phase 24: the leaf libraries and the autoscaler.
LEAF_DIR = "build/leaf"          # workflow storage and job logs
CLIENT_THREADS = 4               # (b) the client's second pass
POOL_CHUNKSIZE = 2               # (c) requests per Pool task
JOB_HOLD_BYTES = 2**30           # (d) what the second job holds on the card
AUTOSCALE_IDLE_S = 2.0           # (f) idle seconds before scale-down
SUBPROCESS_TIMEOUT_S = 300
# Phase 25: a cluster from the CLI, the autopilot, the dashboard head, the
# doctor. The run dirs and the GPU daemon's flight dir go under the
# git-ignored build/. The deployment's linger is deliberately far above
# what one request at a time needs, so the queue wait's p95 sits above half
# of the serve_target_latency_ms knob (100 ms) and the autopilot halves it.
CLI_DIR = "build/cli"
AUTOPILOT_DEPLOYMENT = "lm25"
AUTOPILOT_LINGER_MS = 200.0
AUTOPILOT_CONFIG = {"autopilot_enabled": True,
                    # the controller ticks once at start, then only when
                    # poked, so the reaction is timed from poke()
                    "autopilot_tick_s": 3600.0}
DOOMED_DELAY_MS = 60_000         # (d) the chaos delay that holds the task
MEMORY_BACK_S = 10.0             # (d) the card's memory back within this
# Phase 26: the devtools. (a) the lockwatch run's report, its measured
# passes (after one warm-up pass), its deployment's linger, far above the
# time 16 requests take to arrive, so that every batch fills to
# max_batch_size with or without the watchdog, and its trainer's steps;
# (b) the guard-band cases: each band is GUARD_BAND_ROWS rows of the
# tensor (a tile is at most 128 rows) and at least GUARD_BAND_MIN elements.
LOCKWATCH_REPORT = "build/lockwatch/report.json"
LOCKWATCH_PASSES = 5
LOCKWATCH_LINGER_S = 1.0
LOCKWATCH_DEADLINE_MS = 60_000.0
LOCKWATCH_TRAIN_STEPS = 2
LOCKWATCH_AB_PAIRS = 4
GUARD_BAND_ROWS = 256
GUARD_BAND_MIN = 4096
GUARD_SHAPES = ((200, 200), (1024, 1024), (200, 333))   # (Lq, Lk)
GUARD_HEADS = (2, 200, 4, 64)                           # (B, L, H, D)
# Phase 27: a C++ user program on the port's C++ worker API, built in a
# process of its own from phase 2's end on and run in phase 25's cluster,
# whose head daemon offers no CPU: the program's tasks (1 CPU each) spill
# back to the GPU daemon, whose CPUs leave its actors room beside the
# tasks in flight, so the actor the program creates lands there.
CPP_PROGRAM = "ray_tpu_torch/_native/cpp_serve_lm.cc"
CPP_EXE = "raytpu_cpp_serve_lm"
CLI_GPU_NODE_CPUS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def _kernel_name(mangled: str) -> str:
    """``name<template args>`` of a mangled kernel symbol: the identifier,
    prefixed by its length, that ends in ``_kernel``, and the template
    arguments after it (a length prefix may follow other digits)."""
    for run in re.finditer(r"\d+", mangled):
        digits = run.group()
        for i in range(len(digits)):
            name = mangled[run.end():run.end() + int(digits[i:])]
            if name.endswith("_kernel") and name[:1].isalpha():
                args = mangled[run.end() + len(name):].split("EEv")[0]
                return name + args.replace("I", "<", 1) + ">"
    return mangled


def ptxas_summary(build_log: str):
    """One line per compiled kernel: its registers and spills."""
    name, spills = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and name:
            yield f"{name}: {line.split(':', 1)[1].strip()}; {spills}"


def time_ms(fn, windows: int = 10, window_ms: float = 5.0,
            warmup: int = 3) -> float:
    """Device time of one ``fn()`` call, in ms: after the warm-up, each of
    ``windows`` windows enqueues n calls back to back between one pair of
    CUDA events (n chosen so that a window lasts at least ``window_ms``),
    and the result is the median over windows of elapsed / n. Back to back,
    the host's work for call i + 1 overlaps the device's work for call i,
    so a kernel is not charged its wrapper's host path."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = max(1, math.ceil(window_ms / max(start.elapsed_time(end), 1e-3)))
    per_call = []
    for _ in range(windows):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / n)
    return statistics.median(per_call)


def _bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak rate for the input type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kept_pairs(Lq, Lk, causal):
    """(row, col) pairs a head that the mask keeps (top-left causal)."""
    return sum(min(r + 1, Lk) for r in range(Lq)) if causal else Lq * Lk


def attention_bound(B, Lq, Lk, H, D, dtype, causal):
    """Least time (ms) an H100 needs for the forward: the larger of the bytes
    (q, k, v read once; O and the f32 LSE written once) over the HBM rate
    and the two dots' operations on the (row, col) pairs the mask keeps
    over the peak rate for the input type."""
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = elt * (2 * B * Lq * H * D + 2 * B * Lk * H * D) + 4 * B * H * Lq
    flops = 4.0 * B * H * D * _kept_pairs(Lq, Lk, causal)
    return _bound(nbytes, flops, dtype)


def backward_bounds(B, Lq, Lk, H, D, dtype, causal):
    """Least time (ms) an H100 needs for each backward kernel, as
    ``{"dq": (ms, by), "dkv": (ms, by)}``. Both read q, k, v, dO and the f32
    LSE and Delta once; dq writes dQ (three dots: S, dP, dQ), dkv writes dK
    and dV (four dots: S, dP, dV, dK), on the pairs the mask keeps."""
    elt = torch.tensor([], dtype=dtype).element_size()
    reads = elt * (2 * B * Lq * H * D + 2 * B * Lk * H * D) + 8 * B * H * Lq
    dot = 2.0 * B * H * D * _kept_pairs(Lq, Lk, causal)
    return {"dq": _bound(reads + elt * B * Lq * H * D, 3 * dot, dtype),
            "dkv": _bound(reads + 2 * elt * B * Lk * H * D, 4 * dot, dtype)}


def reference_by_heads(fa, q, k, v, causal):
    """``flash_attention_reference`` over groups of heads, each group's
    [B, heads, Lq, Lk] f32 scores at most 1 GiB, so the cells' shapes fit
    on the card."""
    B, Lq, H, _ = q.shape
    per = max(1, 2**30 // (4 * B * Lq * k.shape[1]))
    parts = [fa.flash_attention_reference(q[:, :, h:h + per],
                                          k[:, :, h:h + per],
                                          v[:, :, h:h + per], causal)
             for h in range(0, H, per)]
    return (torch.cat([o for o, _ in parts], 2),
            torch.cat([lse for _, lse in parts], 1))


def check_bf16_forward(o, lse, ro, rlse, case):
    """bf16 O and LSE against the plain version's: elementwise at TOL, then
    over the whole launch at BF16_LSE_ATOL and BF16_O_REL_L2. Returns
    (largest |LSE error|, relative L2 error of O)."""
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"O differs, {case}: {m}")
    torch.testing.assert_close(lse, rlse, rtol=tol, atol=tol,
                               msg=lambda m: f"LSE differs, {case}: {m}")
    lse_err = (lse - rlse).abs().max().item()
    o_rel = ((o.float() - ro.float()).norm() / ro.float().norm()).item()
    assert lse_err <= BF16_LSE_ATOL, f"LSE off by {lse_err}, {case}"
    assert o_rel <= BF16_O_REL_L2, f"O off by {o_rel} (relative L2), {case}"
    return lse_err, o_rel


def forward_cell_times(fa, device, card):
    """Phase 6 (b): the bf16 causal forward at the training cells' shapes:
    the kernel held against the plain version (run head by head), then
    timed beside SDPA as the yardstick and the least time
    ``perfbench/core/work.py`` counts (two dots on the kept pairs, Q, K and
    V at the model's head counts read once, O and the LSE written once).
    Returns {cell: kernel ms}."""
    from perfbench.core import model as perf_model
    from perfbench.core import work
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    times = {}
    for cell, B, L, H, kv_heads, D in FWD_CELL_SHAPES:
        q, k, v = random_qkv(gen, B, L, L, H, D, torch.bfloat16, device)
        dims = perf_model.Dims(vocab=0, d=H * D, layers=1, heads=H,
                               kv_heads=kv_heads, ff=0, theta=0.0, eps=0.0)
        flops, nbytes = work.attn_fwd_work(B, L, dims)
        bound_ms = 1e3 * work.least_seconds(flops, nbytes)
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        ro, rlse = reference_by_heads(fa, q, k, v, True)
        lse_err, o_rel = check_bf16_forward(o, lse, ro, rlse,
                                            f"{cell}'s shape")
        del o, lse, ro, rlse
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        log(f"[times] {card}: flash_attention_fwd at {cell}'s shape B={B} "
            f"L={L} H={H} D={D} bf16 causal: |LSE error| <= {lse_err:.3g}, "
            f"O {o_rel:.3g} relative L2; kernel {ms:.4f} ms ({100 * bound_ms / ms:.1f}% of "
            f"the bound, {flops / ms / 1e9:.0f} TFLOP/s), SDPA "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB)")
        times[cell] = ms
        del q, k, v, qt, kt, vt
    return times


def adamw_cell_shapes(config_name):
    """The leaf shapes of a training cell's configuration, in the port's
    leaf order (``perfbench``'s leaf specs)."""
    from perfbench.core import model as perf_model
    from perfbench.core import moe_model
    config = json.loads((REPO / "perfbench" / "configs" /
                         f"{config_name}.json").read_text())
    dims = perf_model.dims(config)
    specs = (moe_model.leaf_specs(dims, moe_model.experts(config))
             if "n_routed_experts" in config else perf_model.leaf_specs(dims))
    return [tuple(shape) for _, shape, _, _ in specs]


def _prime_adamw(opt, params, exp_avgs, exp_avg_sqs, step_device):
    """Give a ``torch.optim.AdamW`` the pass's moments as its state (no
    copy), at step 1."""
    for p, m, v in zip(params, exp_avgs, exp_avg_sqs):
        opt.state[p] = {"step": torch.tensor(1.0, device=step_device),
                        "exp_avg": m, "exp_avg_sq": v}


def adamw_against_plain(aw, state, coefs, cell):
    """Phase 28's check at one leaf set: the kernel against the plain
    version, one leaf a round so that the copies stay within the card. Each
    round steps every leaf in one launch and holds one leaf's p, m and v to
    the plain version run on copies taken before it; the moments are zero
    in round 0 and a round's step further on in each later one. Returns
    the largest |error| (a function of its own, so that no copy outlives
    it and the phase's memory readings)."""
    params, grads, exp_avgs, exp_avg_sqs = state
    n = sum(p.numel() for p in params)
    launches = -(-len(params) // aw.MAX_LEAVES)
    want = torch.stack([g.square().sum() for g in grads])
    err = 0.0
    for i in range(len(params)):
        copies = [t[i].detach().clone()
                  for t in (params, exp_avgs, exp_avg_sqs)]
        before = (aw.adamw_launches, aw.adamw_elements)
        sums = aw.adamw_step(*state, coefs)
        torch.cuda.synchronize()
        assert (aw.adamw_launches, aw.adamw_elements) == (
            before[0] + launches, before[1] + n), (
            aw.adamw_launches, aw.adamw_elements, before)
        torch.testing.assert_close(sums, want, rtol=1e-5, atol=0)
        aw.adamw_reference([copies[0]], [grads[i]], [copies[1]],
                           [copies[2]], [coefs[i]])
        for name, got, ref in zip(("param", "exp_avg", "exp_avg_sq"),
                                  (params[i], exp_avgs[i], exp_avg_sqs[i]),
                                  copies):
            # tests/test_torch_kernels.py's tolerance: FMA contraction
            torch.testing.assert_close(
                got.detach(), ref, rtol=1e-6,
                atol=1e-6 * ref.abs().max().item(),
                msg=lambda m: f"{cell} leaf {i} {name}: {m}")
            err = max(err, (got.detach() - ref).abs().max().item())
    log(f"[adamw] {cell}: {len(params)} rounds of {launches} launch(es) "
        f"each, every leaf's param, exp_avg and exp_avg_sq against the plain "
        f"version (rtol 1e-6): largest |error| {err:.3e}; sums of g*g at "
        f"rtol 1e-5")
    return err


@torch.no_grad()
def adamw_phase(device, card, cells=ADAMW_CELLS):
    """Phase 28: the one-pass AdamW kernel (``ops/adamw.py``) at each
    training cell's f32 leaf set. One launch steps every leaf; each leaf's
    param and moments against ``adamw_reference`` and its sum of g*g against
    ``g.square().sum()``; then the kernel's time beside
    its bound (28 bytes a parameter at 3.35 TB/s), the plain version's,
    the parent step's optimizer phase (the norm's own pass, then
    ``torch.optim.AdamW``'s foreach passes) and ``torch.optim.AdamW(fused=
    True)`` as the library's yardstick (the port never calls it); and the
    memory each adds over the state it steps. Returns {cell: times}."""
    from ray_tpu_torch.ops import adamw as aw
    gen = torch.Generator(device=device).manual_seed(SEED + 28)
    out = {}
    for cell, config_name in cells:
        free_device_caches()
        shapes = adamw_cell_shapes(config_name)
        n = sum(math.prod(s) for s in shapes)
        # Weights at a model's initial scale (std 0.02): an update of
        # lr = 3e-4 is then ~1e4 of their ulps, so the check below sees a
        # coefficient that is off by a part in a thousand.
        params = [torch.randn(s, generator=gen, device=device).mul_(0.02)
                  .requires_grad_() for s in shapes]
        grads = [torch.randn(s, generator=gen, device=device)
                 for s in shapes]
        exp_avgs = [torch.zeros_like(p) for p in params]
        exp_avg_sqs = [torch.zeros_like(p) for p in params]
        state = (params, grads, exp_avgs, exp_avg_sqs)
        coefs = [aw.coefficients(1, 3e-4, 0.9, 0.999, 1e-8, 0.01)] * len(
            shapes)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)

        def extra(fn):
            """Device bytes ``fn()`` allocates past the state, at its
            peak."""
            torch.cuda.reset_peak_memory_stats(device)
            fn()
            torch.cuda.synchronize()
            return torch.cuda.max_memory_allocated(device) - base

        err = adamw_against_plain(aw, state, coefs, cell)
        ms = time_ms(lambda: aw.adamw_step(*state, coefs), windows=5)
        kernel_extra = extra(lambda: aw.adamw_step(*state, coefs))
        plain_ms = time_ms(lambda: aw.adamw_reference(*state, coefs),
                           windows=3, warmup=1)
        for p, g in zip(params, grads):
            p.grad = g
        foreach = torch.optim.AdamW(params, lr=3e-4, weight_decay=0.01,
                                    foreach=True)
        _prime_adamw(foreach, params, exp_avgs, exp_avg_sqs, "cpu")

        def parent_phase():
            torch.sqrt(sum(g.square().sum() for g in grads))
            foreach.step()

        parent_ms = time_ms(parent_phase, windows=3, warmup=1)
        parent_extra = extra(parent_phase)
        fused = torch.optim.AdamW(params, lr=3e-4, weight_decay=0.01,
                                  fused=True)
        _prime_adamw(fused, params, exp_avgs, exp_avg_sqs, device)
        library_ms = time_ms(fused.step, windows=3, warmup=1)
        bound_ms = n * ADAMW_BYTES_PER_PARAM / HBM_BYTES_PER_S * 1e3
        log(f"[times] {card}: adamw at {cell}'s leaf set ({len(shapes)} "
            f"leaves, {n} f32 parameters): kernel {ms:.4f} ms "
            f"({100 * bound_ms / ms:.1f}% of the bound, "
            f"{n * ADAMW_BYTES_PER_PARAM / ms / 1e9:.3f} TB/s), bound "
            f"{bound_ms:.4f} ms (bytes, {ADAMW_BYTES_PER_PARAM} B a "
            f"parameter), plain {plain_ms:.4f} ms, the parent's phase "
            f"(norm + foreach AdamW) {parent_ms:.4f} ms, library "
            f"AdamW(fused=True) {library_ms:.4f} ms; memory past the state: "
            f"kernel {kernel_extra / 2**20:.1f} MiB, parent's phase "
            f"{parent_extra / 2**30:.2f} GiB")
        out[cell] = dict(ms=ms, plain_ms=plain_ms, parent_ms=parent_ms,
                         library_ms=library_ms, bound_ms=bound_ms, n=n,
                         max_abs_err=err)
        for p in params:
            p.grad = None
        del params, grads, exp_avgs, exp_avg_sqs, state, foreach, fused
    free_device_caches()
    return out


def random_qkv(gen, B, Lq, Lk, H, D, dtype, device):
    def draw(L):
        return torch.randn((B, L, H, D), generator=gen, device=device
                           ).to(dtype)
    return draw(Lq), draw(Lk), draw(Lk)


def kernel_cases():
    """(B, Lq, Lk, H, D, dtype, causal) of the kernel-vs-plain phases."""
    cases = [(2, L, L, 2, D, dt, c)
             for D in (16, 32, 64, 128)
             for L in (256, 1024, 200)
             for dt in (torch.float32, torch.bfloat16)
             for c in (True, False)]
    cases += [(1, Lq, Lk, 2, 64, dt, c)
              for (Lq, Lk) in ((200, 333), (384, 128))
              for dt in (torch.float32, torch.bfloat16)
              for c in (True, False)]
    # The training cells' heads: 32 of width 128, the blocks many.
    cases += [(2, Lq, Lk, 32, 128, torch.bfloat16, c)
              for (Lq, Lk) in ((200, 333), (1024, 1024))
              for c in (True, False)]
    return cases


def check_kernel(fa, device) -> None:
    """Phase 3: kernel against the plain version, O and LSE."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = kernel_cases()
    before = fa.launches
    worst, whole = {}, (0.0, 0.0)
    for (B, Lq, Lk, H, D, dt, causal) in cases:
        q, k, v = random_qkv(gen, B, Lq, Lk, H, D, dt, device)
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        ro, rlse = fa.flash_attention_reference(q, k, v, causal)
        torch.cuda.synchronize()
        tol = TOL[dt]
        case = f"B={B} Lq={Lq} Lk={Lk} H={H} D={D} {dt} causal={causal}"
        assert o.dtype == dt and lse.dtype == torch.float32, case
        assert lse.shape == (B, H, Lq), case
        if dt == torch.bfloat16:
            lse_err, o_rel = check_bf16_forward(o, lse, ro, rlse, case)
            whole = max(whole[0], lse_err), max(whole[1], o_rel)
        else:
            torch.testing.assert_close(
                o, ro, rtol=tol, atol=tol,
                msg=lambda m: f"O differs, {case}: {m}")
            torch.testing.assert_close(
                lse, rlse, rtol=tol, atol=tol,
                msg=lambda m: f"LSE differs, {case}: {m}")
        err = (o.float() - ro.float()).abs().max().item()
        worst[str(dt)] = max(worst.get(str(dt), 0.0), err)
    assert fa.launches == before + len(cases), (fa.launches, before)
    log(f"[kernels] {len(cases)} cases agree with the plain version "
        f"(O and LSE; f32 at {TOL[torch.float32]}, bf16 at "
        f"{TOL[torch.bfloat16]}, and over a launch |LSE error| <= "
        f"{BF16_LSE_ATOL}, O at {BF16_O_REL_L2} relative L2); largest |dO| "
        f"{worst}; bf16's largest |LSE error| {whole[0]:.3g}, relative L2 "
        f"of O {whole[1]:.3g}")


def last_token_logits(cfg, params, batch):
    """f32 logits at each row's last real token (``batch["last"]``)."""
    from ray_tpu_torch.models import transformer
    tokens, last = batch["tokens"], batch["last"]
    x = transformer.backbone(params, tokens, cfg)
    x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    return transformer.head(params, x, cfg)[:, 0]


def make_deployment(cfg, params, device):
    """User code: a deployment class over the port's serving path."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.air import TorchPredictor
    # A local, so the class body reads it from this function's closure:
    # pickled by value (phase 18 ships this function to a daemon), the
    # function carries only the globals its own code names.
    buckets = BATCH_BUCKETS

    class LMDeployment:
        def __init__(self):
            self.predictor = TorchPredictor(
                params, functools.partial(last_token_logits, cfg),
                device=device)
            self.batches = 0

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.01,
                     pad_batch_to=buckets)
        def __call__(self, requests):
            self.batches += 1
            return list(self.predictor.predict(pad_requests(requests)))

    return LMDeployment()


def pad_requests(requests):
    """Right-pad every request to the batch's length bucket: ``{"tokens",
    "last"}`` as numpy. This is exact only because attention is causal with
    a top-left mask and RoPE positions start at 0: a real token never sees
    the pad tokens to its right, and its position does not move."""
    from ray_tpu_torch.serve.batching import next_bucket
    L = next_bucket(max(len(r) for r in requests), LENGTH_BUCKETS)
    tokens = np.zeros((len(requests), L), dtype=np.int64)
    for i, r in enumerate(requests):
        tokens[i, :len(r)] = r
    last = np.array([len(r) - 1 for r in requests], dtype=np.int64)
    return {"tokens": tokens, "last": last}


def serve_all(deployment, requests, timeout_s: float = 300.0):
    """Submit every request from its own thread; (answers, seconds)."""
    answers = [None] * len(requests)
    errors = []

    def call(i):
        try:
            answers[i] = deployment(requests[i])
        except BaseException as e:  # reported after the join below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    seconds = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), "requests timed out"
    if errors:
        raise errors[0]
    return answers, seconds


def seeded_requests(width=SERVE_WIDTH, n_requests=N_REQUESTS):
    """The seeded requests of phases 5 and 15: (the rng after them,
    lengths, requests)."""
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(1, width["max_seq_len"] + 1, size=n_requests)
    requests = [rng.integers(0, width["vocab_size"], size=n).tolist()
                for n in lengths]
    return rng, lengths, requests


def serve_inputs(device, width=SERVE_WIDTH, n_requests=N_REQUESTS):
    """The seeded requests and f32 weights of phases 5 and 15: (the rng
    after the requests, lengths, requests, f32 config, params)."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig

    rng, lengths, requests = seeded_requests(width, n_requests)
    cfg32 = TransformerConfig(**width, dtype=torch.float32, use_flash=True)
    gen = torch.Generator(device=device).manual_seed(SEED)
    return (rng, lengths, requests, cfg32,
            transformer.init_params(cfg32, gen, device))


def check_dense(cfg32, params, requests, answers, device):
    """Every f32 answer against a one-request, unpadded dense-attention run
    at rtol = atol = 1e-3."""
    from ray_tpu_torch.models import transformer
    dense = dataclasses.replace(cfg32, use_flash=False)
    with torch.inference_mode():
        for req, got in zip(requests, answers):
            tokens = torch.tensor([req], device=device)
            want = transformer.apply(params, tokens, dense)[0, -1]
            np.testing.assert_allclose(got, want.cpu().numpy(), rtol=1e-3,
                                       atol=1e-3)


def serve_phase(fa, device, width=SERVE_WIDTH, n_requests=N_REQUESTS):
    """Phase 5. Returns the bf16 runs' launches, batches, median seconds,
    real tokens per run, and the time of one full-batch forward."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig

    rng, lengths, requests, cfg32, params = serve_inputs(device, width,
                                                         n_requests)
    n_tokens = int(lengths.sum())
    log(f"[serve] {transformer.num_params(params) / 1e6:.1f} M parameters, "
        f"{n_requests} requests, lengths {lengths.tolist()}")

    # f32: every answer against a one-request, unpadded dense-attention run.
    dep = make_deployment(cfg32, params, device)
    fa.launches = 0
    ans32, _ = serve_all(dep, requests)
    assert fa.launches == cfg32.n_layers * dep.batches, (
        fa.launches, dep.batches)
    check_dense(cfg32, params, requests, ans32, device)
    log(f"[serve] f32: {n_requests} answers in {dep.batches} batches match "
        f"the unpadded dense run at rtol=atol=1e-3; kernel launches "
        f"{cfg32.n_layers} per batch")

    # bf16, weights cast once: warm up, then the measured runs.
    cfg16 = TransformerConfig(**width, dtype=torch.bfloat16, use_flash=True)
    params16 = transformer.cast_params(params, torch.bfloat16)
    dep = make_deployment(cfg16, params16, device)
    serve_all(dep, requests)
    dep.batches = 0
    fa.launches = 0
    runs = [serve_all(dep, requests) for _ in range(SERVE_RUNS)]
    launches = fa.launches
    assert launches == cfg16.n_layers * dep.batches, (launches, dep.batches)
    for ans16, _ in runs:
        assert all(np.isfinite(a).all() for a in ans16), "non-finite logits"
        assert all(a.shape == (width["vocab_size"],) for a in ans16)
    delta = max(float(np.abs(a - b).max()) for a, b in zip(runs[0][0], ans32))
    log(f"[serve] bf16: {n_requests} finite answers x {SERVE_RUNS} runs in "
        f"{dep.batches} batches; largest |logit(bf16) - logit(f32)| = "
        f"{delta:.4f}")

    # One full batch (8 x 1024) through the forward, for the time split.
    B, L = BATCH_BUCKETS[-1], LENGTH_BUCKETS[-1]
    batch = {"tokens": torch.tensor(rng.integers(0, width["vocab_size"],
                                                 size=(B, L)), device=device),
             "last": torch.full((B,), L - 1, device=device)}
    with torch.inference_mode():
        forward_ms = time_ms(lambda: last_token_logits(cfg16, params16, batch),
                             windows=5, warmup=1)
    return dict(launches=launches, batches=dep.batches,
                seconds=statistics.median(t for _, t in runs),
                n_tokens=n_tokens, forward_ms=forward_ms,
                n_layers=cfg16.n_layers)


def runtime_phase(fa, device, card, direct_rps, width=SERVE_WIDTH,
                  n_requests=N_REQUESTS, side=OBJECT_SIDE):
    """Phase 15: the in-process runtime (``ray_tpu_torch.init`` → tasks,
    actors, the object store) on the card. Returns the put/get round trip
    in µs and the actor path's bf16 requests/s."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import scheduler, worker

    # (a) init with no GPU argument: the card is detected.
    config = {k: str(REPO / v) for k, v in RUNTIME_CONFIG.items()}
    rt.init(num_cpus=8, _system_config=config)
    try:
        res = rt.cluster_resources()
        assert res.get("GPU") == torch.cuda.device_count(), res
        store = worker.global_worker().runtime.head_node.store
        arena = store.stats()["native_arena"]
        sched = scheduler._native() is not None
        log(f"[runtime] init(num_cpus=8): {res}; native object arena "
            f"{'loaded' if arena else 'NOT loaded (heap store)'}, native "
            f"scheduling library "
            f"{'loaded' if sched else 'NOT loaded (Python policy)'}")
        put_get_us = device_objects(rt, device, card, side)
        actor_rps = actor_serving(rt, fa, device, card, direct_rps, width,
                                  n_requests)
        gpu_task(rt, device)
    finally:
        rt.shutdown()
    # (e) a second runtime in the same process.
    rt.init(num_cpus=2)
    try:
        assert rt.get(rt.remote(lambda: 7).remote(), timeout=60) == 7
        assert rt.cluster_resources().get("GPU") == torch.cuda.device_count()
    finally:
        rt.shutdown()
    log("[runtime] shutdown(), then a second init() in the same process "
        "ran a task")
    return dict(put_get_us=put_get_us, actor_rps=actor_rps)


def device_objects(rt, device, card, side=OBJECT_SIDE):
    """Phase 15 (b): a CUDA tensor is a device object, by reference, ready
    for its getter, and refused once written in place. Returns the put/get
    round trip's median in µs (host clock)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    a, b = (torch.randn(side, side, generator=gen, device=device,
                        dtype=torch.bfloat16) for _ in range(2))
    torch.cuda.synchronize()
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        # The product is queued behind ~50 ms of spinning, so a reader
        # that did not wait for the put's event would read it unfinished.
        torch.cuda._sleep(SIDE_STREAM_SLEEP_CYCLES)
        x = a @ b
        allocated = torch.cuda.memory_allocated(device)
        ref = rt.put(x)

    @rt.remote
    def fetch(refs):
        return rt.get(refs[0])   # a nested ref: this task gets it itself

    got = rt.get(fetch.remote([ref]))
    assert got is x
    assert torch.cuda.memory_allocated(device) == allocated
    early = got.cpu()            # on this thread's stream, no host sync
    torch.cuda.synchronize()
    assert torch.equal(early, x.cpu()), "get returned the object unfinished"
    log(f"[runtime] a bf16 [{side}, {side}] tensor written on a side stream "
        f"and put: get from another task returns the same object, device "
        f"memory unchanged ({allocated} bytes), and its values equal a "
        f"host-synchronised copy")

    x.add_(1)   # raylint: allow(jit-stability) the write is the check: get must refuse the ref
    try:
        rt.get(ref)
    except rt.RayTpuError as e:
        assert "modified in place" in str(e), e
    else:
        raise AssertionError("get of an object written in place succeeded")
    log("[runtime] after an in-place write, get refuses the object")

    times = []
    for _ in range(PUT_GET_RUNS):
        t0 = time.perf_counter()
        assert rt.get(rt.put(x)) is x
        times.append(time.perf_counter() - t0)
    assert torch.cuda.memory_allocated(device) == allocated
    us = statistics.median(times) * 1e6
    log(f"[times] {card}: put/get round trip of that tensor {us:.1f} µs "
        f"(host clock, median of {PUT_GET_RUNS}); device memory unchanged")
    del a, b, x, got, early
    torch.cuda.empty_cache()
    return us


def actor_serving(rt, fa, device, card, direct_rps, width=SERVE_WIDTH,
                  n_requests=N_REQUESTS):
    """Phase 15 (c): phase 5's deployment, weights and requests, served
    from a ``num_gpus=1`` actor. Returns the bf16 requests/s."""
    from ray_tpu_torch.models import transformer

    _, lengths, requests, cfg32, params = serve_inputs(device, width,
                                                       n_requests)

    @rt.remote(num_gpus=1, max_concurrency=n_requests)
    class LMServer:
        """User code: the deployment inside a GPU actor."""

        def __init__(self, cfg, params):
            self.deployment = make_deployment(cfg, params, device)

        def devices(self):
            return rt.get_runtime_context().get_gpu_devices()

        def batches(self):
            return self.deployment.batches

        def __call__(self, request):
            return self.deployment(request)

    def serve_pass(server):
        # The handle refuses dunder attributes (``server.__call__`` is the
        # handle's own), so the method is named through ActorMethod.
        call = rt.ActorMethod(server, "__call__")
        t0 = time.perf_counter()
        answers = rt.get([call.remote(r) for r in requests], timeout=600)
        return answers, time.perf_counter() - t0

    server = LMServer.remote(cfg32, params)
    devices = rt.get(server.devices.remote(), timeout=600)
    assert devices == [torch.device("cuda", 0)], devices
    fa.launches = 0
    ans32, _ = serve_pass(server)
    batches = rt.get(server.batches.remote())
    assert fa.launches == cfg32.n_layers * batches, (fa.launches, batches)
    check_dense(cfg32, params, requests, ans32, device)
    log(f"[runtime] f32 from a num_gpus=1 actor granted {devices}: "
        f"{n_requests} answers in {batches} batches match the unpadded "
        f"dense run at rtol=atol=1e-3; kernel launches {cfg32.n_layers} per "
        f"batch")
    rt.kill(server)

    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    params16 = transformer.cast_params(params, torch.bfloat16)
    del params
    server = LMServer.remote(cfg16, params16)
    serve_pass(server)
    before = rt.get(server.batches.remote(), timeout=600)
    fa.launches = 0
    runs = [serve_pass(server) for _ in range(SERVE_RUNS)]
    launches = fa.launches
    batches = rt.get(server.batches.remote()) - before
    assert launches == cfg16.n_layers * batches, (launches, batches)
    for answers, _ in runs:
        assert all(np.isfinite(a).all() for a in answers), "non-finite logits"
        assert all(a.shape == (width["vocab_size"],) for a in answers)
    seconds = statistics.median(t for _, t in runs)
    rps = n_requests / seconds
    log(f"[runtime] bf16 from the actor: {n_requests} finite answers x "
        f"{SERVE_RUNS} passes in {batches} batches; kernel launches "
        f"{cfg16.n_layers} per batch")
    log(f"[times] {card}: bf16 serving from a num_gpus=1 actor {rps:.2f} "
        f"requests/s, {int(lengths.sum()) / seconds:.0f} tokens/s (median "
        f"of {SERVE_RUNS} passes, {seconds:.4f} s); phase 5 direct "
        f"{direct_rps:.2f} requests/s")
    rt.kill(server)
    return rps


def gpu_task(rt, device):
    """Phase 15 (d): a ``num_gpus=1`` task over a CUDA tensor, given as an
    ObjectRef and as a plain argument, and a GPU request no node can meet."""
    @rt.remote(num_gpus=1, num_returns=2)
    def gram(t):
        return t @ t.T, t.data_ptr()

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    z = torch.randn(1024, 1024, generator=gen, device=device)
    want = z @ z.T
    for arg in (rt.put(z), z):
        out, ptr = rt.get(list(gram.remote(arg)), timeout=60)
        assert ptr == z.data_ptr() and out.device == z.device, (ptr, out)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    too_many = torch.cuda.device_count() + 1
    try:
        rt.get(rt.remote(num_gpus=too_many)(lambda: 1).remote(), timeout=60)
    except rt.RayTpuError as e:
        assert "cannot be satisfied" in str(e), e
    else:
        raise AssertionError(f"a task asking for {too_many} GPUs ran")
    log(f"[runtime] a num_gpus=1 task got the CUDA tensor with no copy (as "
        f"an ObjectRef and as an argument) and returned z @ z.T on "
        f"{out.device}, equal to the direct product at 1e-5; a task asking "
        f"for {too_many} GPUs is infeasible")


class ServedLM:
    """User code for phase 16: phase 5's model as a Serve deployment whose
    replica batches requests itself (``max_batch_size`` on the deployment),
    so ``__call__`` takes a list. ``answer`` picks what a request gets back:
    its logit row as numpy ("numpy"), as a list for JSON ("list"), or the
    replica's tag with the row as a CUDA tensor ("tensor")."""

    def __init__(self, cfg, params, answer, device):
        import uuid

        import ray_tpu_torch
        from ray_tpu_torch.air import TorchPredictor
        self.granted = ray_tpu_torch.get_runtime_context().get_gpu_devices()
        # A fractional grant names no device: the replica picks the card.
        self.predictor = TorchPredictor(
            params, functools.partial(last_token_logits, cfg),
            device=self.granted[0] if self.granted else device)
        self.cfg, self.answer = cfg, answer
        self.tag = uuid.uuid4().hex[:8]
        self.sizes, self.busy_s = [], 0.0

    def __call__(self, requests):
        t0 = time.perf_counter()
        try:
            return self._answer(requests)
        finally:
            self.sizes.append(len(requests))
            self.busy_s += time.perf_counter() - t0

    def _answer(self, requests):
        batch = pad_requests(requests)
        if self.answer == "tensor":
            dev = self.predictor.device
            with torch.no_grad():
                rows = last_token_logits(
                    self.cfg, self.predictor.params,
                    {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()})
            return [(self.tag, row.clone()) for row in rows]
        rows = self.predictor.predict(batch)
        return [r.tolist() for r in rows] if self.answer == "list" \
            else list(rows)

    def devices(self):
        return self.granted

    def stats(self):
        """(batch sizes, seconds spent answering batches) so far."""
        return list(self.sizes), self.busy_s


def free_device_caches():
    """Collect garbage and return cached blocks, cuBLAS's workspaces too
    (one per handle and stream, allocated through the caching allocator),
    so ``memory_allocated`` counts live tensors only."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def http_post(url, body, timeout_s=300.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        return json.loads(r.read())


def http_status(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def serve_thread_names():
    return [t for t in threading.enumerate() if t.name.startswith("serve-")]


def serve_plane_phase(fa, device, card, direct_rps, actor_rps,
                      width=SERVE_WIDTH, n_requests=N_REQUESTS):
    """Phase 16: phase 5's weights and requests through the Serve plane
    (controller, replicas, router, handles, HTTP proxy) on the in-process
    runtime; then teardown: no serve thread is left and device memory
    returns to where it was."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    free_device_caches()
    before = torch.cuda.memory_allocated(device)
    # Earlier phases' @serve.batch queues keep their own threads.
    threads_before = set(serve_thread_names())
    config = {k: str(REPO / v) for k, v in RUNTIME_CONFIG.items()}
    rt.init(num_cpus=8, _system_config=config)
    try:
        res = rt.cluster_resources()
        assert res.get("GPU") == torch.cuda.device_count(), res
        rates = serve_plane_paths(rt, serve, fa, device, card, direct_rps,
                                  actor_rps, width, n_requests)
    finally:
        t0 = time.perf_counter()
        serve.shutdown()
        rt.shutdown()
    # (e) teardown
    deadline = time.monotonic() + 10.0
    while (set(serve_thread_names()) - threads_before
           and time.monotonic() < deadline):
        time.sleep(0.05)
    left = set(serve_thread_names()) - threads_before
    assert not left, left
    free_device_caches()
    after = torch.cuda.memory_allocated(device)
    assert abs(after - before) <= SERVE_MEMORY_SLACK, (before, after)
    log(f"[serve-plane] (e) serve.shutdown() and shutdown() in "
        f"{time.perf_counter() - t0:.2f} s: no serve thread left; device "
        f"memory {before} bytes before the phase, {after} after (the "
        f"replicas' weights went with their actors)")
    return rates


def serve_plane_paths(rt, serve, fa, device, card, direct_rps, actor_rps,
                      width, n_requests):
    """Phase 16 (a)-(d), on one deployment named "lm" at ``SERVE_ROUTE``:
    f32 from a ``num_gpus=1`` replica by handle and by HTTP, a rolling
    update to bf16, and one to two ``num_gpus=0.5`` replicas. Keeping one
    deployment keeps every router and the proxy's handle live until
    ``serve.shutdown``, whose delete then wakes their long polls."""
    from ray_tpu_torch.models import transformer

    _, lengths, requests, cfg32, params = serve_inputs(device, width,
                                                       n_requests)
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    n_layers, n_tokens = cfg32.n_layers, int(lengths.sum())
    lm = serve.deployment(
        ServedLM, name="lm", max_batch_size=8, batch_wait_timeout_s=0.01,
        pad_batch_to=BATCH_BUCKETS, target_latency_ms=SERVE_BUDGET_MS,
        ray_actor_options={"num_gpus": 1})

    def deploy(app, what):
        t0 = time.perf_counter()
        handle = serve.run(app, route_prefix=SERVE_ROUTE)
        log(f"[serve-plane] serve.run ({what}) returned a ready handle in "
            f"{time.perf_counter() - t0:.2f} s")
        return handle

    def by_handle(handle):
        return serve_all(lambda r: handle.remote(r).result(timeout=300),
                         requests)

    def batches(handle):
        return len(handle.stats.remote().result(timeout=60)[0])

    # (a) handle, f32, one num_gpus=1 replica
    t0 = time.perf_counter()
    h = deploy(lm.bind(cfg32, params, "list", device), "f32, num_gpus=1")
    devices = h.devices.remote().result(timeout=60)
    assert devices == [torch.device("cuda", 0)], devices
    fa.launches, b0 = 0, batches(h)
    answers, _ = by_handle(h)
    ran = batches(h) - b0
    assert fa.launches == n_layers * ran, (fa.launches, ran)
    check_dense(cfg32, params, requests, answers, device)
    f32_s = statistics.median(by_handle(h)[1] for _ in range(SERVE_RUNS))
    log(f"[serve-plane] (a) f32 by handle from a num_gpus=1 replica granted "
        f"{devices}: {n_requests} answers in {ran} batches match the "
        f"unpadded dense run at rtol=atol=1e-3; kernel launches {n_layers} "
        f"per batch ({time.perf_counter() - t0:.2f} s)")

    # (c) HTTP, f32, the same replica
    t0 = time.perf_counter()
    base = serve.start_http_proxy()
    url = base + SERVE_ROUTE
    fa.launches, b0 = 0, batches(h)
    answers, _ = serve_all(lambda r: http_post(url, r), requests)
    ran = batches(h) - b0
    assert fa.launches == n_layers * ran, (fa.launches, ran)
    check_dense(cfg32, params, requests, answers, device)
    assert http_status(base + "/-/healthz")[0] == 200
    code, body = http_status(base + "/-/routes")
    assert code == 200 and json.loads(body) == {SERVE_ROUTE: "lm"}, body
    assert http_status(base + "/no-such-route")[0] == 404
    http_s = statistics.median(
        serve_all(lambda r: http_post(url, r), requests)[1]
        for _ in range(SERVE_RUNS))
    log(f"[serve-plane] (c) f32 by HTTP POST to {SERVE_ROUTE}: {n_requests} "
        f"JSON logit rows in {ran} batches match the dense run at 1e-3; "
        f"/-/healthz 200, /-/routes lists the route, an unknown route 404 "
        f"({time.perf_counter() - t0:.2f} s)")
    log(f"[times] {card}: f32 serving through the Serve plane, answers as "
        f"lists: by handle {n_requests / f32_s:.2f} requests/s, by HTTP "
        f"{n_requests / http_s:.2f} requests/s (medians of {SERVE_RUNS} "
        f"passes, {f32_s:.4f} / {http_s:.4f} s)")

    # (b) handle, bf16: a rolling update of the same deployment
    t0 = time.perf_counter()
    params16 = transformer.cast_params(params, torch.bfloat16)
    del params
    h = deploy(lm.bind(cfg16, params16, "numpy", device),
               "rolling update to bf16")
    by_handle(h)

    def measured(submit):
        """``SERVE_RUNS`` passes: (median seconds, batch sizes, seconds the
        replica spent answering them, seconds of all the passes)."""
        fa.launches = 0
        sizes0, busy0 = h.stats.remote().result(timeout=60)
        runs = [submit() for _ in range(SERVE_RUNS)]
        sizes, busy = h.stats.remote().result(timeout=60)
        sizes = sizes[len(sizes0):]
        assert fa.launches == n_layers * len(sizes), (fa.launches, sizes)
        for answers, _ in runs:
            assert all(np.isfinite(a).all() for a in answers), \
                "non-finite logits"
            assert all(a.shape == (width["vocab_size"],) for a in answers)
        return (statistics.median(t for _, t in runs), sizes, busy - busy0,
                sum(t for _, t in runs))

    def one_thread():
        t0 = time.perf_counter()
        responses = [h.remote(r) for r in requests]
        answers = [r.result(timeout=300) for r in responses]
        return answers, time.perf_counter() - t0

    threads = measured(lambda: by_handle(h))
    single = measured(one_thread)
    log(f"[serve-plane] (b) bf16 by handle: {n_requests} finite answers x "
        f"{SERVE_RUNS} passes from {n_requests} threads and x {SERVE_RUNS} "
        f"from one thread; kernel launches {n_layers} per batch "
        f"({time.perf_counter() - t0:.2f} s)")
    for what, (seconds, sizes, busy, total) in (
            (f"from {n_requests} threads", threads),
            ("from one thread", single)):
        log(f"[times] {card}: bf16 serving through the Serve plane {what} "
            f"{n_requests / seconds:.2f} requests/s, "
            f"{n_tokens / seconds:.0f} tokens/s (median of {SERVE_RUNS} "
            f"passes, {seconds:.4f} s); the replica answered batches of "
            f"{sizes} for {busy:.4f} s of the passes' {total:.4f} s (host "
            f"clock)")
    log(f"[times] {card}: phase 5 direct {direct_rps:.2f}, phase 15 actor "
        f"{actor_rps:.2f} requests/s")

    # (d) two num_gpus=0.5 replicas on the card
    t0 = time.perf_counter()
    h = deploy(lm.options(num_replicas=2, ray_actor_options={"num_gpus": 0.5})
               .bind(cfg16, params16, "tensor", device),
               "rolling update to 2 replicas, num_gpus=0.5")
    fa.launches = 0
    answers, seconds = by_handle(h)
    served = collections.Counter(tag for tag, _ in answers)
    assert len(served) == 2, served
    for _, row in answers:
        assert row.is_cuda and row.shape == (width["vocab_size"],), row.shape
        assert torch.isfinite(row).all().item(), "non-finite logits"
    assert fa.launches >= 2 * n_layers and fa.launches % n_layers == 0, \
        fa.launches
    log(f"[serve-plane] (d) bf16 from two num_gpus=0.5 replicas (no device "
        f"granted; user code on {answers[0][1].device}): requests served "
        f"{sorted(served.values())}, answers finite CUDA tensors read on the "
        f"callers' threads; {fa.launches // n_layers} batches in one pass "
        f"({seconds:.4f} s; {time.perf_counter() - t0:.2f} s)")
    return {"threads": n_requests / threads[0],
            "single": n_requests / single[0]}


def assert_grads_close(got, want, dtype, case):
    """Check each gradient at GRAD_TOL_F32 (f32) or GRAD_REL_BF16 of its
    largest |value| (bf16). Returns ``{name: (largest |error|, largest
    share of the allowed error atol + rtol * |want|)}``."""
    out = {}
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, (name, case)
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            tol = dict(rtol=GRAD_TOL_F32, atol=GRAD_TOL_F32)
        else:
            tol = dict(rtol=GRAD_REL_BF16,
                       atol=GRAD_REL_BF16 * w.abs().max().item())
        torch.testing.assert_close(g, w, **tol,
                                   msg=lambda m: f"{name} differs, {case}: "
                                                 f"{m}")
        err = (g - w).abs()
        allowed = (tol["atol"] + tol["rtol"] * w.abs()).clamp_min(1e-30)
        out[name] = (err.max().item(), (err / allowed).max().item())
    return out


def _merge_worst(worst, dtype, errs):
    """Keep, per (dtype, gradient), the largest error and tolerance share."""
    for name, (err, share) in errs.items():
        e, s = worst.get(f"{dtype} {name}", (0.0, 0.0))
        worst[f"{dtype} {name}"] = (max(e, err), max(s, share))


def _fmt_worst(worst):
    return "; ".join(f"{k} {e:.4g} ({s:.2f})" for k, (e, s) in worst.items())


def check_backward(fa, device) -> None:
    """Phase 7: the dq and dkv kernels against the plain backward; then the
    same cases through ``_FlashAttention`` against autograd of the plain
    forward."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    cases = kernel_cases()
    worst = {}
    before = (fa.dq_launches, fa.dkv_launches)
    for (B, Lq, Lk, H, D, dt, causal) in cases:
        case = f"B={B} Lq={Lq} Lk={Lk} H={H} D={D} {dt} causal={causal}"
        q, k, v = random_qkv(gen, B, Lq, Lk, H, D, dt, device)
        do = torch.randn(q.shape, generator=gen, device=device).to(dt)
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        _merge_worst(worst, dt, assert_grads_close(got, want, dt, case))
        if causal and Lk > Lq:  # K rows no query reaches: exact zeros
            assert not got[1][:, Lq:].any(), case
            assert not got[2][:, Lq:].any(), case
    assert (fa.dq_launches, fa.dkv_launches) == (
        before[0] + len(cases), before[1] + len(cases)), before
    log(f"[backward] {len(cases)} cases: dq and dkv kernels agree with the "
        f"plain backward (f32 at {GRAD_TOL_F32}, bf16 at {GRAD_REL_BF16} of "
        f"the largest |grad|); largest |error| (share of the tolerance): "
        f"{_fmt_worst(worst)}")

    worst = {}
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    for (B, Lq, Lk, H, D, dt, causal) in cases:
        case = f"autograd B={B} Lq={Lq} Lk={Lk} D={D} {dt} causal={causal}"
        q, k, v = (t.requires_grad_() for t in
                   random_qkv(gen, B, Lq, Lk, H, D, dt, device))
        do = torch.randn(q.shape, generator=gen, device=device).to(dt)
        out = fa.flash_attention(q, k, v, causal)
        assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
        got = torch.autograd.grad(out, (q, k, v), do)
        ref, _ = fa.flash_attention_reference(q, k, v, causal)
        want = torch.autograd.grad(ref, (q, k, v), do)
        torch.cuda.synchronize()
        _merge_worst(worst, dt, assert_grads_close(got, want, dt, case))
    n = len(cases)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (
        before[0] + n, before[1] + n, before[2] + n), before
    log(f"[backward] the same {n} cases through the autograd Function agree "
        f"with autograd of the plain forward; largest |error| (share of "
        f"the tolerance): {_fmt_worst(worst)}")


def train_trajectory(cfg, params, tokens, steps, device, mesh=None):
    """(loss, grad_norm) of ``steps`` steps of ``make_lm_train_step`` (over
    ``mesh`` when given) from a copy of ``params`` on one batch."""
    from ray_tpu_torch.train import make_lm_train_step
    init_fn, step_fn, shard_batch = make_lm_train_step(cfg, mesh,
                                                       device=device)
    state = init_fn(params=params)
    batch = shard_batch(tokens)
    out = []
    for _ in range(steps):
        state, metrics = step_fn(state, batch)
        out.append((metrics["loss"].item(), metrics["grad_norm"].item()))
    return out


def parity_inputs(device, width=PARITY_WIDTH, batch=PARITY_BATCH):
    """Phase 8's f32 flash config, weights and token batch."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    tokens = np.random.default_rng(SEED + 3).integers(
        0, width["vocab_size"], size=batch)
    flash = TransformerConfig(**width, dtype=torch.float32, use_flash=True)
    params = transformer.init_params(
        flash, torch.Generator(device=device).manual_seed(SEED + 3), device)
    return flash, params, tokens


def train_parity_phase(device, width=PARITY_WIDTH, batch=PARITY_BATCH,
                       steps=PARITY_STEPS):
    """Phase 8: f32 steps through the kernels against dense attention (TF32
    off), from the same weights on the same batch. Returns the trajectory
    through the kernels."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    flash, params, tokens = parity_inputs(device, width, batch)
    dense = TransformerConfig(**width, dtype=torch.float32, use_flash=False)
    got = train_trajectory(flash, params, tokens, steps, device)
    want = train_trajectory(dense, params, tokens, steps, device)
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL)
    log(f"[train] f32 parity, {width['n_layers']} layers at d_model "
        f"{width['d_model']}, batch {batch[0]} x {batch[1]}: (loss, grad "
        f"norm) through the kernels {got} vs dense attention {want}, "
        f"rtol {TRAIN_RTOL}")
    return got


def launch_counts(fa):
    return (fa.launches, fa.dq_launches, fa.dkv_launches)


def adamw_ops():
    return importlib.import_module("ray_tpu_torch.ops.adamw")


def adamw_per_step(opt):
    """The AdamW kernel's launches in one step of ``opt``: one a table of
    up to ``MAX_LEAVES`` leaves."""
    n = sum(len(group["params"]) for group in opt.param_groups)
    return -(-n // adamw_ops().MAX_LEAVES)


def train_phase(fa, device, width=SERVE_WIDTH, batch=TRAIN_BATCH,
                steps=TRAIN_STEPS, mesh=None, profile=True):
    """Phase 9, the training path: bf16 steps at full depth with remat
    (phase 14 (c): the same through the sharded step over ``mesh``)."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import make_lm_train_step
    cfg = TransformerConfig(**width, dtype=torch.bfloat16, use_flash=True)
    assert cfg.remat
    n = cfg.n_layers
    per_step = (2 * n, n, n)  # remat recomputes each block's forward
    init_fn, step_fn, shard_batch = make_lm_train_step(cfg, mesh,
                                                       device=device)
    state = init_fn(torch.Generator(device=device).manual_seed(SEED))
    n_params = transformer.num_params(state[0])
    tokens = shard_batch(np.random.default_rng(SEED + 4).integers(
        0, width["vocab_size"], size=batch))
    aw = adamw_ops()
    adamw_step = adamw_per_step(state[1])

    def one_step(state):
        before = launch_counts(fa) + (aw.adamw_launches,)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        loss = metrics["loss"].item()
        grad_norm = metrics["grad_norm"].item()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = tuple(a - b for a, b in zip(
            launch_counts(fa) + (aw.adamw_launches,), before))
        assert got == per_step + (adamw_step,), (got, per_step, adamw_step)
        return state, loss, grad_norm, seconds

    state, loss, grad_norm, warm_s = one_step(state)     # warm-up
    losses, norms, times = [loss], [grad_norm], []
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    aw.adamw_launches = 0
    for _ in range(steps):
        state, loss, grad_norm, seconds = one_step(state)
        losses.append(loss)
        norms.append(grad_norm)
        times.append(seconds)
    launches = launch_counts(fa)
    assert launches == tuple(steps * c for c in per_step), launches
    assert aw.adamw_launches == steps * adamw_step, aw.adamw_launches
    assert all(np.isfinite(losses + norms)), (losses, norms)
    assert losses[-1] < losses[0], losses
    step_s = statistics.median(times)
    n_tokens = batch[0] * (batch[1] - 1)
    out = dict(launches=launches, adamw_launches=aw.adamw_launches,
               step_ms=step_s * 1e3, tokens_per_s=n_tokens / step_s,
               # bench.py's count: 6 FLOPs a parameter a token (2 forward,
               # 4 backward), remat's recompute not counted.
               model_tflops=6.0 * n_params * n_tokens / step_s / 1e12,
               peak_bytes=torch.cuda.max_memory_allocated(), n_layers=n,
               losses=losses)
    where = "" if mesh is None else f" (sharded, mesh {mesh.shape})"
    log(f"[train] bf16{where}, {n_params / 1e6:.1f} M parameters, {n} layers,"
        f" remat, batch {batch[0]} x {batch[1]}: losses {losses}, grad norms "
        f"{norms}; warm-up step {warm_s:.3f} s; launches a step "
        f"{per_step} (forward, dq, dkv) and {adamw_step} AdamW; {launches} "
        f"and {out['adamw_launches']} in {steps} steps")
    if profile:
        log_profile("transformer training step",
                    profile_steps(lambda: step_fn(state, tokens)))
    return out


def sharded_phase(fa, device, parity_want, phase9_ms):
    """Phase 14: the sharded step. (a) ``dryrun_multichip`` on every card;
    (b) f32 parity with phase 8 and (c) phase 9's bf16 training, both
    through ``make_lm_train_step`` over a mesh of one rank in this
    process. Returns (c)'s results."""
    import torch.distributed as dist
    from ray_tpu_torch.entry import dryrun_multichip
    from ray_tpu_torch.parallel import MeshConfig, build_mesh

    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    t0 = time.perf_counter()
    out = dryrun_multichip(n_cards, device=device)
    log(f"[sharded] (a) dryrun_multichip({n_cards}) over "
        f"{'NCCL' if device.type == 'cuda' else 'gloo'} in "
        f"{time.perf_counter() - t0:.1f} s: losses {out}")
    assert out and all(np.isfinite(v) for v in out.values()), out

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
        **({"device_id": torch.device("cuda", torch.cuda.current_device())}
           if device.type == "cuda" else {}))
    try:
        mesh = build_mesh(MeshConfig(data=1), device)
        assert set(mesh.shape.values()) == {1}, mesh.shape
        # (b) f32 through the kernels, against phase 8's one-device run.
        flash, params, tokens = parity_inputs(device)
        got = train_trajectory(flash, params, tokens, PARITY_STEPS, device,
                               mesh=mesh)
        np.testing.assert_allclose(got, parity_want, rtol=TRAIN_RTOL)
        log(f"[sharded] (b) f32 parity over mesh {mesh.shape}: (loss, grad "
            f"norm) {got} vs phase 8's one-device {parity_want}, rtol "
            f"{TRAIN_RTOL}")
        del params
        # (c) bf16 at full width, phase 9's weights and batch.
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        res = train_phase(fa, device, mesh=mesh, profile=False)
        log(f"[sharded] (c) bf16 sharded step {res['step_ms']:.3f} ms "
            f"(median of {TRAIN_STEPS}) against phase 9's {phase9_ms:.3f} ms "
            f"in this run; {res['tokens_per_s']:.0f} tokens/s, peak memory "
            f"{res['peak_bytes'] / 2**30:.2f} GiB; launches "
            f"{res['launches']}")
        res["paired"] = paired_step_times(device, mesh)
    finally:
        dist.destroy_process_group()
    return res


def paired_step_times(device, mesh, width=SERVE_WIDTH, batch=TRAIN_BATCH,
                      rounds=STEP_PAIRS):
    """Phase 14 (d): the one-device and the sharded bf16 step (phase 9's
    model, weights and batch) timed in turns, one-device, sharded, sharded,
    one-device in each round, after one warm-up step each, so that the
    host's drift falls on both. Returns each path's step times (ms)."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import make_lm_train_step
    cfg = TransformerConfig(**width, dtype=torch.bfloat16, use_flash=True)
    tokens = np.random.default_rng(SEED + 4).integers(
        0, width["vocab_size"], size=batch)
    paths = {}
    for name, m in (("one-device", None), ("sharded", mesh)):
        init_fn, step_fn, shard_batch = make_lm_train_step(cfg, m,
                                                           device=device)
        state = init_fn(torch.Generator(device=device).manual_seed(SEED))
        paths[name] = [step_fn, state, shard_batch(tokens)]
    times = {name: [] for name in paths}
    order = ["one-device", "sharded"] + ["one-device", "sharded", "sharded",
                                         "one-device"] * rounds
    for i, name in enumerate(order):
        step_fn, state, batch_ = paths[name]
        t0 = time.perf_counter()
        paths[name][1], metrics = step_fn(state, batch_)
        metrics["loss"].item()
        torch.cuda.synchronize()
        if i >= 2:                               # the first two warm up
            times[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"[sharded] (d) bf16 step in turns, {rounds} rounds of one-device, "
        f"sharded, sharded, one-device: median one-device "
        f"{med['one-device']:.3f} ms, sharded {med['sharded']:.3f} ms; all "
        f"(ms): " + "; ".join(f"{k} " + ", ".join(f"{t:.1f}" for t in v)
                              for k, v in times.items()))
    return times


def backward_times(fa, device, B, L, H, D, dt):
    """Phase 10: each backward kernel, the plain backward and the SDPA
    backward (``torch.autograd.grad`` on its output: the yardstick for the
    pair, never called by the port) on one causal input, with the kernels'
    largest |error| against the plain backward and their bounds."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    q, k, v = random_qkv(gen, B, L, L, H, D, dt, device)
    do = torch.randn(q.shape, generator=gen, device=device).to(dt)
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, True)
    errs = assert_grads_close(got, want, dt, "training shape")
    del got, want
    scale = 1.0 / D ** 0.5
    delta = fa.attention_delta(out, do)
    res = dict(dq_err=errs["dq"][0],
               dkv_err=max(errs["dk"][0], errs["dv"][0]))
    res["dq_ms"] = time_ms(lambda: fa._launch_dq(q, k, v, do, lse, delta,
                                                 True, scale))
    res["dkv_ms"] = time_ms(lambda: fa._launch_dkv(q, k, v, do, lse, delta,
                                                   True, scale))
    res["plain_ms"] = time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, True), windows=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    def sdpa_bwd():
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

    res["library_ms"] = time_ms(sdpa_bwd)
    # read twice, around one more kernel run: SDPA's backward has read
    # more than 2x apart between runs
    time_ms(lambda: fa._launch_dkv(q, k, v, do, lse, delta, True, scale))
    res["library_ms_repeat"] = time_ms(sdpa_bwd)
    bounds = backward_bounds(B, L, L, H, D, dt, True)
    res["dq_bound"], res["dkv_bound"] = bounds["dq"], bounds["dkv"]
    return res


def conv_layouts(fn):
    """Run ``fn()`` and return ``(its result, forward convs, backward convs,
    tensors not channels_last)``: every 4-d input and output of each
    ``aten.convolution`` and ``aten.convolution_backward`` it dispatches is
    checked with ``is_contiguous(memory_format=torch.channels_last)``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    seen = {"fwd": 0, "bwd": 0}
    bad = []

    def check(name, tensors):
        for i, t in enumerate(tensors):
            if (isinstance(t, torch.Tensor) and t.dim() == 4 and
                    not t.is_contiguous(memory_format=torch.channels_last)):
                bad.append(f"{name}[{i}] {tuple(t.shape)} {t.stride()}")

    class Layouts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten.convolution.default:
                seen["fwd"] += 1
                check("convolution", (*args[:2], out))
            elif func is aten.convolution_backward.default:
                seen["bwd"] += 1
                check("convolution_backward", (*args[:2], out[0]))
            return out

    with Layouts():
        result = fn()
    return result, seen["fwd"], seen["bwd"], bad


def _assert_close_scaled(got, want, what, tol=RESNET_RTOL):
    """Hold ``got`` (card) against ``want`` (CPU) at ``tol`` of each value
    plus ``tol`` of the largest |want|; returns the largest share of that
    allowed error."""
    got, want = got.detach().cpu().double(), want.detach().double()
    atol = tol * max(want.abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=tol, atol=atol,
                               msg=lambda m: f"{what} differs: {m}")
    return ((got - want).abs() / (atol + tol * want.abs())).max().item()


def resnet_parity_phase(device, sides=RESNET_PARITY_SIDES,
                        batch=RESNET_PARITY_BATCH):
    """Phase 11: f32 ResNet-18 on the card against the port's CPU run, from
    the same weights: logits, loss and every gradient."""
    from ray_tpu_torch.models import resnet
    cfg = dataclasses.replace(resnet.resnet18(num_classes=10),
                              dtype=torch.float32)
    cpu = torch.device("cpu")

    def run(dev, images, labels):
        params = resnet.init_params(
            cfg, torch.Generator().manual_seed(SEED + 6), dev)
        leaves = resnet.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        x, y = torch.tensor(images, device=dev), torch.tensor(labels,
                                                              device=dev)
        logits = resnet.apply(params, x, cfg)
        loss = resnet.loss_fn(params, x, y, cfg)
        return [logits, loss, *torch.autograd.grad(loss, leaves)]

    worst = {}
    for side in sides:
        rng = np.random.default_rng(SEED + side)
        images = rng.standard_normal((batch, side, side, 3), dtype=np.float32)
        labels = rng.integers(0, cfg.num_classes, size=batch)
        got = run(device, images, labels)
        want = run(cpu, images, labels)
        assert len(got) == len(want) == 2 + len(resnet.leaves(
            resnet.param_shapes(cfg)))
        names = ["logits", "loss"] + [f"grad {i}" for i in
                                      range(len(got) - 2)]
        shares = [_assert_close_scaled(g, w, f"{n} at {side}x{side}")
                  for g, w, n in zip(got, want, names)]
        worst[side] = (shares[0], shares[1], max(shares[2:]))
    log(f"[resnet] f32 parity, resnet18 (10 classes), batch {batch}: card "
        f"against CPU at rtol {RESNET_RTOL} plus {RESNET_RTOL} of each "
        f"tensor's largest |value|; largest share of that tolerance "
        f"(logits, loss, gradients) by side: {worst}")


def resnet_train_phase(device, name, batch, steps=RESNET_STEPS):
    """Phase 12 for one model: bf16 training on one seeded batch; returns
    step ms, images/s, model TFLOP/s, MFU and peak memory."""
    from ray_tpu_torch import bench
    step, cfg, n_params = bench.resnet_train_step(name, batch=batch,
                                                  device=device)
    t0 = time.perf_counter()
    loss, n_fwd, n_bwd, bad = conv_layouts(step)     # warm-up
    losses = [loss.item()]
    warm_s = time.perf_counter() - t0
    assert n_fwd > 0 and n_bwd == n_fwd, (n_fwd, n_bwd)
    assert not bad, f"convolution tensors not channels_last: {bad[:8]}"
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step().item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    assert all(np.isfinite(losses)), losses
    # Falling: the first update lowers the loss. SGD(0.1, momentum 0.9)
    # with no warm-up, on one batch of noise with random labels, overshoots
    # a few steps later at full width (in JAX too), so the last loss is
    # not held below the first.
    assert losses[1] < losses[0], losses
    step_s = statistics.median(times)
    flops = 3 * bench.FORWARD_FLOPS_PER_IMAGE[name] * batch / step_s
    peak = bench.peak_bf16_flops(torch.cuda.get_device_name(0))
    out = dict(step_ms=step_s * 1e3, images_per_s=batch / step_s,
               model_tflops=flops / 1e12,
               mfu_pct=None if peak is None else 100 * flops / peak,
               peak_bytes=torch.cuda.max_memory_allocated())
    log(f"[resnet] {name} bf16, {n_params / 1e6:.2f} M parameters, batch "
        f"{batch} x 224 x 224: losses {[round(x, 4) for x in losses]}; "
        f"warm-up step {warm_s:.3f} s; {n_fwd} convolutions forward and "
        f"{n_bwd} backward, every tensor channels_last")
    log_profile(name, profile_steps(step))
    return out


def profile_steps(step, steps=3, top=8):
    """Where a step's time goes: ``torch.profiler`` over ``steps`` calls of
    ``step()``. Returns the host seconds of the window, the share of it in
    which the device ran a kernel (union of kernel intervals), the
    ``top`` operators by the device time of the kernels they launched
    themselves, each with its share of all kernel time and its calls, and
    the counts of kernels and of copies (memcpy, memset) the device ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    device_events = [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_events)
    assert spans, "the profiler saw no device activity"
    copies = sum(e.name.startswith(("Memcpy", "Memset"))
                 for e in device_events)
    busy, end = 0, -math.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    ops = [(a.key, a.self_device_time_total, a.count)
           for a in prof.key_averages()
           if a.device_type == DeviceType.CPU and a.self_device_time_total]
    total = sum(us for _, us, _ in ops)
    ranked = sorted(ops, key=lambda o: -o[1])[:top]
    return dict(wall_s=wall_s, busy_share=busy * 1e-6 / wall_s,
                top=[(key, us / total, n) for key, us, n in ranked],
                kernels=len(device_events) - copies, copies=copies)


def log_profile(what, prof):
    top = "; ".join(f"{k} {100 * s:.1f}% ({n})" for k, s, n in prof["top"])
    log(f"[profile] {what}: 3 steps in {prof['wall_s']:.3f} s, device busy "
        f"{100 * prof['busy_share']:.1f}% of it; operators by the device "
        f"time of their own kernels (share of all kernel time, calls): {top}")


def bench_phase(timeout_s=BENCH_TIMEOUT_S):
    """Phase 13: the port's bench in a subprocess, as a user runs it.
    Returns its headline and its transformer section's progress line."""
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout_s)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"[bench] {line}")
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-4000:])
    head = json.loads(lines[-1])
    sections = {d["metric"]: d for d in map(json.loads, lines[:-1])
                if d.get("unit") == "progress"}
    ex = head["extras"]
    assert head["backend_available"] is True, head
    assert head["probe_failed"] is False, head
    for value in (head["value"], head["mfu_pct"],
                  ex["resnet18_images_per_sec"],
                  ex["transformer_tokens_per_sec"],
                  ex["transformer_mfu_pct"], ex["ppo_env_steps_per_sec"]):
        assert value is not None and value > 0, head
    assert head["errors"] is None, (head["errors"], proc.stderr[-4000:])
    assert sections["section_ppo"]["learner_device"] == "cuda", sections
    return head, sections["section_transformer"]


# -- phase 17: TorchTrainer ---------------------------------------------------


def _numpy_tree_to_torch(tree, device="cpu"):
    """A numpy tree (a restored checkpoint, host weights) with its arrays
    as tensors on ``device``."""
    from ray_tpu_torch._private.host import from_numpy
    if isinstance(tree, dict):
        return {k: _numpy_tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree_to_torch(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return from_numpy(tree, None, device)
    return tree


def lm_trainer_loop(config):
    """Phases 17 (a), (b) and 26 (a): the training loop a user hands
    ``TorchTrainer``. It runs in a train worker: it builds
    ``make_lm_train_step`` on the session's mesh, starts from
    ``config["params"]`` where given, else from ``config["seed"]``'s
    weights, or from ``session.get_checkpoint()`` (parameters, AdamW state
    and step), and
    reports every step; every ``config["ckpt_every"]``-th report carries the
    full state. ``config["fail_at"]``: the first attempt raises after that
    step's report. ``config["timings"]``: a list the loop appends each
    report's host-clock ms to (the workers are threads of this process)."""
    from torch.distributed.tensor import DTensor
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import make_lm_train_step, session

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    device = torch.device(config["device"])
    cfg = TransformerConfig(**config["width"], dtype=config["dtype"],
                            use_flash=True)
    mesh = session.get_mesh()
    if device.type == "cuda":
        # the mesh rule: one worker granted a whole card
        assert mesh is not None and set(mesh.shape.values()) == {1}, mesh
    init_fn, step_fn, shard = make_lm_train_step(cfg, mesh, device=device)
    restored = session.get_checkpoint()
    if restored is None and "params" in config:
        state = init_fn(params=config["params"])
        start = 0
    elif restored is None:
        state = init_fn(torch.Generator(device=device).manual_seed(
            config["seed"]))
        start = 0
    else:
        saved = _numpy_tree_to_torch(restored.to_dict())
        state = init_fn(params=saved["params"])
        for s in saved["opt"]["state"].values():
            # the engine stores a 0-d leaf as shape (1,), as the JAX
            # package's does (np.ascontiguousarray)
            s["step"] = s["step"].reshape(())
        state[1].load_state_dict(saved["opt"])
        start = int(saved["step"])
        adam_steps = {float(s["step"]) for s in state[1].state.values()}
        assert adam_steps == {float(start)}, (adam_steps, start)
    tokens = (shard if mesh is None else session.shard_batch)(
        config["tokens"])
    aw = adamw_ops()
    for step in range(start + 1, config["steps"] + 1):
        before = launch_counts(fa)
        adamw_before = aw.adamw_launches
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        loss = metrics["loss"].item()
        grad_norm = metrics["grad_norm"].item()
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launched = tuple(a - b for a, b in zip(launch_counts(fa), before))
        ckpt = None
        if step % config["ckpt_every"] == 0:
            params, opt = state
            ckpt = Checkpoint.from_dict({
                "params": transformer._tree_map(
                    lambda p: p.to_local() if isinstance(p, DTensor) else p,
                    params),
                "opt": opt.state_dict(), "step": step})
        t1 = time.perf_counter()
        session.report({"step": step, "loss": loss, "grad_norm": grad_norm,
                        "step_ms": step_ms, "launches": launched,
                        "adamw_launches": aw.adamw_launches - adamw_before,
                        "adamw_per_step": adamw_per_step(state[1]),
                        "resumed_from": start}, checkpoint=ckpt)
        config["timings"].append((step, ckpt is not None,
                                  (time.perf_counter() - t1) * 1e3))
        if step == config.get("fail_at") and restored is None:
            raise RuntimeError(f"simulated worker crash after step {step}")


def _count_params(shapes) -> int:
    if isinstance(shapes, dict):
        return sum(_count_params(v) for v in shapes.values())
    return math.prod(shapes)


def _chunk_bytes(root: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in (root / "chunks").rglob("*")
               if f.is_file())


def _perf_mean_ms(snap, name):
    h = snap["hists"].get(name)
    return None if h is None else h["sum_ms"] / max(1, sum(h["counts"]))


def _assert_same_bytes(got, want, path="state"):
    """``got`` (restored numpy tree) holds ``want``'s (host tensor tree)
    values byte for byte, dtype and shape included (a 0-d leaf comes back
    as shape (1,): the engine stores it so, as the JAX package's does)."""
    from ray_tpu_torch._private.host import to_numpy
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same_bytes(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_bytes(g, w, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        w = to_numpy(want)
        shape = (1,) if w.ndim == 0 else w.shape
        assert got.dtype == w.dtype and got.shape == shape, (
            path, got.dtype, w.dtype, got.shape, w.shape)
        assert np.ascontiguousarray(got).tobytes() == \
            np.ascontiguousarray(w).tobytes(), path
    else:
        assert got == want, (path, got, want)


def trainer_full_phase(rt, fa, device, card, phase9_ms, root,
                       width=SERVE_WIDTH, batch=TRAIN_BATCH,
                       steps=TRAINER_STEPS):
    """Phase 17 (a): phase 9's model, weights and batch trained by
    ``TorchTrainer`` in one ``use_gpu`` worker on the ``nccl`` group, 1 +
    ``steps`` steps, the full state checkpointed at every third report (two
    kept); then the newest committed state restored and held against the
    host copy taken at that step. Returns the launches of the run and its
    median step ms."""
    from ray_tpu_torch.air import (Checkpoint, CheckpointConfig, RunConfig,
                                   ScalingConfig)
    from ray_tpu_torch.checkpoint import list_manifest_names, read_manifest
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.observability import goodput, perf
    from ray_tpu_torch.train import TorchTrainer

    cfg = TransformerConfig(**width, dtype=torch.bfloat16, use_flash=True)
    assert cfg.remat
    n = cfg.n_layers
    per_step = (2 * n, n, n)
    n_params = _count_params(transformer.param_shapes(cfg))
    state_bytes = 3 * 4 * n_params       # f32 parameters and two moments
    free = shutil.disk_usage(root.parent).free
    # two commits kept, a reported state spilled by the object store (it
    # is larger than the store), and slack
    need = 3 * state_bytes + 2**31
    if free < need:
        raise RuntimeError(
            f"phase 17 (a) keeps two checkpoints of {state_bytes / 1e9:.2f} "
            f"GB: it needs {need / 1e9:.2f} GB free under {root.parent}, "
            f"which has {free / 1e9:.2f} GB")
    timings = []
    config = dict(width=width, dtype=torch.bfloat16, device=str(device),
                  seed=SEED, steps=1 + steps, ckpt_every=3, timings=timings,
                  tokens=np.random.default_rng(SEED + 4).integers(
                      0, width["vocab_size"], size=batch))
    trainer = TorchTrainer(
        lm_trainer_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=1,
                                     use_gpu=device.type == "cuda"),
        run_config=RunConfig(name="full", storage_path=str(root),
                             checkpoint_config=CheckpointConfig(
                                 num_to_keep=2)),
        results_timeout_s=TRAINER_TIMEOUT_S)
    perf_was = perf.ENABLED
    perf.enable()
    perf.reset()
    goodput.reset()
    aw = adamw_ops()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    aw.adamw_launches = 0
    t0 = time.perf_counter()
    result = trainer.fit()
    fit_s = time.perf_counter() - t0
    launches = launch_counts(fa)
    adamw_launches = aw.adamw_launches
    snap, ledger = perf.snapshot(), goodput.snapshot()
    if not perf_was:
        perf.disable()
    assert result.error is None, result.error
    hist = result.metrics_history
    assert [m["step"] for m in hist] == list(range(1, steps + 2)), hist
    losses = [m["loss"] for m in hist]
    norms = [m["grad_norm"] for m in hist]
    assert all(np.isfinite(losses + norms)), (losses, norms)
    assert losses[-1] < losses[0], losses
    assert all(m["launches"] == per_step for m in hist), \
        [m["launches"] for m in hist]
    assert launches == tuple((steps + 1) * c for c in per_step), launches
    assert all(m["adamw_launches"] == m["adamw_per_step"] for m in hist), \
        [(m["adamw_launches"], m["adamw_per_step"]) for m in hist]
    assert adamw_launches == sum(m["adamw_per_step"] for m in hist), \
        adamw_launches
    step_ms = statistics.median(m["step_ms"] for m in hist[1:])
    report_ms = [ms for _, saved, ms in timings if not saved]
    enqueue_ms = [ms for _, saved, ms in timings if saved]
    # (a) the newest committed state, restored, against the host copy
    # taken at its step
    ckpt_root = root / "full" / "checkpoints"
    names = list_manifest_names(str(ckpt_root))
    manifests = [read_manifest(str(ckpt_root), nm) for nm in names]
    # the engine numbers commits by reported checkpoint (steps 3, 6, ...)
    commits = (steps + 1) // 3
    assert sorted(m.step for m in manifests) == list(
        range(max(1, commits - 1), commits + 1)), [m.step for m in manifests]
    t0 = time.perf_counter()
    restored = Checkpoint.from_manifest(str(ckpt_root)).to_dict()
    restore_s = time.perf_counter() - t0
    want = result.checkpoint.to_dict()
    last = 3 * commits
    assert want["step"] == last and restored["step"] == last
    _assert_same_bytes(restored, want)
    commit_bytes = [sum(e.nbytes for s in m.shards for e in s.arrays)
                    for m in manifests]
    cats = ledger["jobs"]["default"]["cats"]
    log(f"[trainer] (a) {free / 1e9:.1f} GB free under {root.parent} at the "
        f"start; TorchTrainer, 1 use_gpu worker on the nccl group, "
        f"mesh data=1: bf16, {n_params / 1e6:.1f} M parameters, {n} layers, "
        f"remat, batch {batch[0]} x {batch[1]}: losses {losses}, grad norms "
        f"{norms}; launches a step {per_step} (forward, dq, dkv) and "
        f"{hist[0]['adamw_per_step']} AdamW, {launches} and "
        f"{adamw_launches} in {steps + 1} steps; fit() {fit_s:.1f} s")
    log(f"[times] {card}: TorchTrainer bf16 step {step_ms:.3f} ms (median of "
        f"{steps}; steps in ms: "
        + ", ".join(f"{m['step_ms']:.1f}" for m in hist)
        + f"), phase 9's direct step {phase9_ms:.3f} ms in this run; "
        f"session.report {statistics.median(report_ms):.3f} ms without a "
        f"checkpoint (median of {len(report_ms)}), "
        + ", ".join(f"{ms:.1f}" for ms in enqueue_ms)
        + " ms with one (the host snapshot and the engine's enqueue)")
    log(f"[times] {card}: checkpoint of {state_bytes / 1e9:.3f} GB (f32 "
        f"parameters and AdamW moments): engine enqueue mean "
        f"{_perf_mean_ms(snap, 'train.ckpt_enqueue'):.1f} ms, commit (hash, "
        f"write, manifest) mean {_perf_mean_ms(snap, 'ckpt.save') / 1e3:.3f}"
        f" s, hash per chunk mean {_perf_mean_ms(snap, 'ckpt.hash'):.1f} ms,"
        f" write per chunk mean {_perf_mean_ms(snap, 'ckpt.write'):.1f} ms; "
        f"bytes per commit {commit_bytes}, on disk {_chunk_bytes(ckpt_root)}"
        f"; restore of step {last} {restore_s:.3f} s, byte for byte equal to the "
        f"host copy taken at that step")
    log(f"[trainer] (a) goodput ledger (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(cats.items()))
        + f"; compiles {ledger['jobs']['default']['compile_count']}")
    return launches, step_ms, adamw_launches


def trainer_restart_phase(rt, fa, device, root, width=PARITY_WIDTH,
                          batch=PARITY_BATCH, steps=6, fail_at=3):
    """Phase 17 (b): phase 8's model, weights and batch in one ``use_gpu``
    worker, a checkpoint at every report; the first attempt raises after
    step ``fail_at``'s report and the trainer restarts it from the last
    committed manifest. Steps after the restart follow an uninterrupted
    direct run at ``TRAIN_RTOL``, and device memory returns to its value
    before ``fit``. Returns the launches of the run."""
    from ray_tpu_torch.air import (CheckpointConfig, FailureConfig,
                                   RunConfig, ScalingConfig)
    from ray_tpu_torch.checkpoint import list_manifest_names, read_manifest
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.observability import goodput
    from ray_tpu_torch.train import TorchTrainer

    flash, params, tokens = parity_inputs(device, width, batch)
    want = train_trajectory(flash, params, tokens, steps, device)
    del params
    per_step = ((2 if flash.remat else 1) * width["n_layers"],
                width["n_layers"], width["n_layers"])
    free_device_caches()
    before = torch.cuda.memory_allocated(device)
    config = dict(width=width, dtype=torch.float32, device=str(device),
                  seed=SEED + 3, steps=steps, ckpt_every=1, fail_at=fail_at,
                  timings=[], tokens=tokens)
    trainer = TorchTrainer(
        lm_trainer_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=1,
                                     use_gpu=device.type == "cuda"),
        run_config=RunConfig(
            name="restart", storage_path=str(root),
            failure_config=FailureConfig(max_failures=1),
            checkpoint_config=CheckpointConfig(num_to_keep=2)),
        results_timeout_s=TRAINER_TIMEOUT_S)
    goodput.reset()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    result = trainer.fit()
    launches = launch_counts(fa)
    downtime = goodput.snapshot()["jobs"]["default"]["cats"].get(
        "restart_downtime", 0.0)
    assert result.error is None, result.error
    hist = result.metrics_history
    first = [m for m in hist if m["resumed_from"] == 0]
    resumed = [m for m in hist if m["resumed_from"] > 0]
    assert [m["step"] for m in first] == list(range(1, fail_at + 1)), hist
    start = resumed[0]["resumed_from"]
    assert 1 <= start <= fail_at, start
    assert [m["step"] for m in resumed] == list(range(start + 1, steps + 1))
    assert all(m["launches"] == per_step for m in hist), hist
    assert downtime > 0.0, downtime
    ckpt_root = root / "restart" / "checkpoints"
    kept = sorted(read_manifest(str(ckpt_root), nm).step
                  for nm in list_manifest_names(str(ckpt_root)))
    # base_step carried: the resumed attempt numbers its saves after the
    # committed one, so the newest commit is the last step
    assert kept[-1] == steps, kept
    got = {m["step"]: (m["loss"], m["grad_norm"]) for m in resumed}
    after = [got[s] for s in range(fail_at + 1, steps + 1)]
    np.testing.assert_allclose(after, want[fail_at:], rtol=TRAIN_RTOL)
    worst = max(abs(g - w) / abs(w) for pair_g, pair_w in
                zip(after, want[fail_at:]) for g, w in zip(pair_g, pair_w))
    del result, trainer, config
    free_device_caches()
    after_bytes = torch.cuda.memory_allocated(device)
    assert abs(after_bytes - before) <= SERVE_MEMORY_SLACK, (before,
                                                             after_bytes)
    log(f"[trainer] (b) failure and restart, f32, {width['n_layers']} "
        f"layers, batch {batch[0]} x {batch[1]}, a checkpoint every report: "
        f"the first attempt raised after step {fail_at}; the restart "
        f"resumed from the committed step {start} (AdamW step restored) "
        f"after {downtime:.3f} s of restart downtime; kept commits {kept}; "
        f"(loss, grad norm) of steps {fail_at + 1}-{steps} {after} vs an "
        f"uninterrupted run {want[fail_at:]}, largest relative difference "
        f"{worst:.3g} (rtol {TRAIN_RTOL}); device memory {before} bytes "
        f"before fit(), {after_bytes} after")
    return launches


def halves_loop(config):
    """Phase 17 (c): one of two workers sharing the card. Each trains phase
    8's model on its half of phase 8's batch, allreduces its gradients on
    the ``nccl`` group (SUM, then / 2), steps AdamW, and reports the
    allreduce's result pointer, dtype and device beside its times."""
    from ray_tpu_torch import collective
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import adamw, session

    rank, world = session.get_world_rank(), session.get_world_size()
    group = session.get_collective_group_name()
    assert session.get_mesh() is None      # threads share one process
    device = torch.device(config["device"])   # a half grant names no card
    cfg = TransformerConfig(**config["width"], dtype=torch.float32,
                            use_flash=True)
    params = transformer._tree_map(
        lambda t: t.detach().to(device, torch.float32, copy=True)
        .requires_grad_(True), config["params"])
    leaves = transformer.leaves(params)
    opt = adamw()(leaves)
    tokens = torch.as_tensor(config["tokens"][rank::world]).to(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    for step in range(1, config["steps"] + 1):
        t0 = time.perf_counter()
        loss = transformer.loss_fn(params, tokens, cfg)
        grads = torch.autograd.grad(loss, leaves)
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1)])
        sync()
        t1 = time.perf_counter()
        summed = collective.allreduce(flat, group)
        sync()
        allreduce_ms = (time.perf_counter() - t1) * 1e3
        mean = summed / world
        with torch.no_grad():
            offset = 0
            for p in leaves:
                p.grad = mean[offset:offset + p.numel()].view_as(p)
                offset += p.numel()
            grad_norm = mean[:-1].norm().item()
            opt.step()
            for p in leaves:
                p.grad = None
        sync()
        session.report({
            "step": step, "loss": mean[-1].item(), "grad_norm": grad_norm,
            "allreduce_ms": allreduce_ms,
            "step_ms": (time.perf_counter() - t0) * 1e3,
            "values": flat.numel(),
            "out": (summed.data_ptr(), str(summed.dtype), str(summed.device)),
            "in": (flat.data_ptr(), str(flat.dtype), str(flat.device))})


def trainer_halves_phase(rt, fa, device, card, parity_want,
                         width=PARITY_WIDTH, batch=PARITY_BATCH,
                         steps=PARITY_STEPS):
    """Phase 17 (c): two workers of ``num_gpus=0.5`` on one card, the
    ``nccl`` group folding both ranks onto it: the allreduced trajectory
    follows phase 8's one-worker full-batch run at ``TRAIN_RTOL``. Returns
    the launches of the run."""
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import TorchTrainer

    flash, params, tokens = parity_inputs(device, width, batch)
    config = dict(width=width, device=str(device), params=params,
                  tokens=tokens, steps=steps)
    trainer = TorchTrainer(
        halves_loop, train_loop_config=config,
        scaling_config=ScalingConfig(
            num_workers=2, resources_per_worker=(
                {"CPU": 1, "GPU": 0.5} if device.type == "cuda"
                else {"CPU": 1})),
        results_timeout_s=TRAINER_TIMEOUT_S)
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    result = trainer.fit()
    launches = launch_counts(fa)
    assert result.error is None, result.error
    hist = result.metrics_history
    assert len(hist) == 2 * steps, hist
    by_step = collections.defaultdict(list)
    for m in hist:
        by_step[m["step"]].append(m)
    got = []
    for s in range(1, steps + 1):
        ranks = by_step[s]
        assert len(ranks) == 2, ranks
        for m in ranks:
            # a CUDA tensor of the input's dtype, on the input's device
            assert m["out"][1:] == m["in"][1:], m
            assert m["out"][2].startswith(device.type), m
        outs = {m["out"][0] for m in ranks}
        assert len(outs) == 2 and not outs & {m["in"][0] for m in ranks}, \
            ranks                   # no rank's output aliases another's
        assert ranks[0]["loss"] == ranks[1]["loss"], ranks
        got.append((ranks[0]["loss"], ranks[0]["grad_norm"]))
    np.testing.assert_allclose(got, parity_want, rtol=TRAIN_RTOL)
    n = width["n_layers"]
    per_step = ((2 if flash.remat else 1) * n, n, n)
    assert launches == tuple(2 * steps * c for c in per_step), launches
    ar = [m["allreduce_ms"] for m in hist]
    st = [m["step_ms"] for m in hist]
    log(f"[trainer] (c) two num_gpus=0.5 workers on one card, nccl group "
        f"folded onto {device}: (loss, grad norm) {got} vs phase 8's "
        f"one-worker full batch {parity_want}, rtol {TRAIN_RTOL}; each "
        f"result a new {hist[0]['out'][1]} tensor on {hist[0]['out'][2]}")
    log(f"[times] {card}: two half-card workers, f32, {n} layers, batch 1 x "
        f"{batch[1]} each: allreduce of {hist[0]['values']} f32 values {statistics.median(ar):.3f} ms (synchronized, median "
        f"of {len(ar)}: " + ", ".join(f"{v:.2f}" for v in ar)
        + f"), step {statistics.median(st):.3f} ms (median of {len(st)})")
    return launches


def nccl_distinct_phase(device):
    """Phase 17 (d): the nccl group over distinct cards, one rank per card
    (one ``torch.cuda.nccl`` call per op). It needs two or more cards."""
    from ray_tpu_torch import collective
    n = min(torch.cuda.device_count(), 4) if device.type == "cuda" else 1
    if n < 2:
        log(f"[trainer] (d) not run: the nccl group over distinct cards "
            f"needs two or more, and this machine has {n}")
        return
    outs = [None] * n
    errors = []

    def rank_body(r):
        try:
            dev = torch.device("cuda", r)
            collective.init_collective_group(n, r, "nccl", "distinct")
            x = torch.full((1024,), float(r + 1), device=dev)
            outs[r] = (collective.allreduce(x, "distinct"),
                       collective.allgather(x, "distinct"))
            collective.destroy_collective_group("distinct")
        except Exception as e:      # surfaced below, after every join
            errors.append(e)

    threads = [threading.Thread(target=rank_body, args=(r,))
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and all(o is not None for o in outs), errors
    total = n * (n + 1) / 2
    for r, (red, gathered) in enumerate(outs):
        assert red.device == torch.device("cuda", r), red.device
        assert torch.all(red == total).item()
        assert gathered.shape == (n, 1024)
    log(f"[trainer] (d) nccl group over {n} distinct cards: allreduce and "
        f"allgather right on every rank")


def trainer_phase(fa, device, card, phase9_ms, parity_want):
    """Phase 17: ``TorchTrainer`` on ``init(num_cpus=8)`` with the card
    detected: (a) full width, (b) failure and restart, (c) two workers
    sharing the card, (d) distinct cards (needs two). The checkpoint
    directory is made under the git-ignored build/ and deleted at the end.
    Returns the launches of (a), (b) and (c), summed, (a)'s median step
    ms and (a)'s AdamW launches."""
    import ray_tpu_torch as rt
    root = REPO / TRAINER_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    config = {k: str(REPO / v) for k, v in RUNTIME_CONFIG.items()}
    rt.init(num_cpus=8, _system_config=config)
    try:
        res = rt.cluster_resources()
        assert res.get("GPU", 0) == torch.cuda.device_count(), res
        launches, full_ms, adamw_launches = trainer_full_phase(
            rt, fa, device, card, phase9_ms, root)
        totals = [launches]
        torch.cuda.empty_cache()
        totals.append(trainer_restart_phase(rt, fa, device, root))
        totals.append(trainer_halves_phase(rt, fa, device, card,
                                           parity_want))
        nccl_distinct_phase(device)
    finally:
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    return tuple(map(sum, zip(*totals))), full_ms, adamw_launches


# -- phase 18: the multi-process runtime --------------------------------------


def seeded_bf16(side, seed, device):
    """A bf16 [side, side] tensor from a seeded generator on ``device``: the
    same bits in every process on the same card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(side, side, generator=gen, device=device,
                       dtype=torch.bfloat16)


def _torch_tree_to_numpy(tree):
    """A parameter tree with its tensors as host numpy arrays."""
    if isinstance(tree, dict):
        return {k: _torch_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def _tree_nbytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(v) for v in tree)
    return tree.nbytes


class TensorKeeper:
    """User code for phase 18 (b): an actor in the GPU daemon that builds
    the seeded tensor on its own card."""

    def __init__(self, side, seed, device):
        self.t = seeded_bf16(side, seed, device)

    def tensor(self):
        return self.t

    def matches(self, x):
        """Whether ``x`` (a driver put, fetched by this process) equals the
        tensor built here, and the device it landed on."""
        return torch.equal(x, self.t), str(x.device)


class DaemonLM:
    """User code for phase 18 (c): phase 5's deployment in an actor of the
    GPU daemon. The f32 weights come as host numpy through the object plane
    (``refs[0]``, fetched here and timed); ``switch`` casts them in place of
    a rolling update, since the daemon's one card holds one such actor."""

    def __init__(self, cfg, refs, device):
        import ray_tpu_torch
        # TF32 off for the f32 check, as in this script's process. Imported
        # here: a ``torch.backends`` submodule named through the global
        # ``torch`` would make this class unpicklable by value.
        from torch.backends.cuda import matmul
        from torch.backends import cudnn
        matmul.allow_tf32 = False
        cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        host = ray_tpu_torch.get(refs[0])
        self.fetch = (time.perf_counter() - t0, _tree_nbytes(host))
        self.device = device
        self.params = {"float32": _numpy_tree_to_torch(host, device)}
        self.cfg = cfg
        self.deployment = make_deployment(cfg, self.params["float32"], device)
        self.fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    def loaded(self):
        """(seconds, bytes) of the weights' fetch, and where this runs."""
        import os

        import ray_tpu_torch
        return (self.fetch, os.getpid(),
                ray_tpu_torch.get_runtime_context().get_gpu_devices())

    def switch(self, dtype_name):
        from ray_tpu_torch.models import transformer
        dtype = getattr(torch, dtype_name)
        self.cfg = dataclasses.replace(self.cfg, dtype=dtype)
        self.params[dtype_name] = transformer.cast_params(
            self.params["float32"], dtype)
        self.deployment = make_deployment(self.cfg, self.params[dtype_name],
                                          self.device)

    def reset_counts(self):
        self.fa.launches = 0
        self.deployment.batches = 0

    def counts(self):
        """(forward-kernel launches in this process, batches served) since
        the last ``reset_counts``."""
        return self.fa.launches, self.deployment.batches

    def __call__(self, request):
        return self.deployment(request)


def process_runtime_phase(fa, device, card, rates, width=SERVE_WIDTH,
                          n_requests=N_REQUESTS, side=OBJECT_SIDE, gpus=1):
    """Phase 18: the multi-process runtime on the card. ``rates``: phases
    5, 15 and 16's bf16 requests/s, printed beside this phase's. Returns
    the flash forward kernel's launches counted in the daemon's process
    and (c)'s bf16 requests/s from 16 threads and from one."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import ProcessCluster

    free_device_caches()
    free_before = torch.cuda.mem_get_info(device)[0]
    t0 = time.perf_counter()
    cluster = ProcessCluster(num_daemons=1, num_cpus=4)
    cpu_s = time.perf_counter() - t0
    procs = [cluster.state_proc]
    try:
        t0 = time.perf_counter()
        gpu_index = len(cluster.daemons)
        cluster.add_daemon(num_gpus=gpus)
        gpu_s = time.perf_counter() - t0
        procs += [d["proc"] for d in cluster.daemons]
        rt.init(address=cluster.address)
        try:
            launches, served = process_runtime_paths(
                rt, cluster, gpu_index, fa, device, card, rates, width,
                n_requests, side, gpus, cpu_s, gpu_s, free_before, procs)
        finally:
            rt.shutdown()
    finally:
        cluster.shutdown()
    # (e) nothing of the cluster outlives it
    procs += [d["proc"] for d in cluster.daemons]
    left = [p.pid for p in procs if p.poll() is None]
    assert not left, left
    log(f"[process-runtime] (e) shutdown() and cluster.shutdown(): none of "
        f"the {len(set(procs))} state-service and daemon processes is left")
    return launches, served


def process_runtime_paths(rt, cluster, gpu_index, fa, device, card, rates,
                          width, n_requests, side, gpus, cpu_s, gpu_s,
                          free_before, procs):
    """Phase 18 (a)-(d) on a live cluster, with this process its driver."""
    import os

    from ray_tpu_torch._private import worker

    on_card = device.type == "cuda"
    # (a) the GPU daemon owns the card, in a process of its own
    res = rt.cluster_resources()
    assert res.get("GPU", 0.0) == float(gpus), res
    cards = cluster.daemons[gpu_index]["cards"]

    @rt.remote(num_gpus=gpus)
    def where():
        import os as _os

        import ray_tpu_torch
        return (_os.getpid(), _os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.get_device_name() if torch.cuda.is_available()
                else None,
                ray_tpu_torch.get_runtime_context().get_gpu_devices())

    pid, visible, name, granted = rt.get(where.remote(), timeout=300)
    assert pid != os.getpid(), pid
    if gpus:
        assert visible == ",".join(cards) and granted == [
            torch.device("cuda", 0)], (visible, cards, granted)
        assert name == torch.cuda.get_device_name(0), name
    log(f"[process-runtime] (a) ProcessCluster on the Python state service: "
        f"a CPU daemon registered {cpu_s:.2f} s after the cluster's start "
        f"(state service included), the GPU daemon "
        f"{gpu_s:.2f} s after add_daemon(num_gpus={gpus}); "
        f"cluster_resources() {res}; a num_gpus={gpus} task ran in pid {pid} "
        f"(the driver is {os.getpid()}) with CUDA_VISIBLE_DEVICES={visible!r}"
        f" on {name}, granted {granted}")

    # (b) tensors between processes
    keeper = rt.remote(num_gpus=gpus)(TensorKeeper).remote(side, SEED + 4,
                                                            device)
    want = seeded_bf16(side, SEED + 4, device)
    got = rt.get(keeper.tensor.remote(), timeout=300)  # warm-up
    nbytes = want.numel() * want.element_size()
    from_daemon = []
    for _ in range(HOP_RUNS):
        t0 = time.perf_counter()
        got = rt.get(keeper.tensor.remote(), timeout=300)
        from_daemon.append(time.perf_counter() - t0)
    assert got.device == want.device and torch.equal(got, want), got.device
    to_daemon = []
    for _ in range(HOP_RUNS):
        ref = rt.put(want)
        t0 = time.perf_counter()
        equal, landed = rt.get(keeper.matches.remote(ref), timeout=300)
        to_daemon.append(time.perf_counter() - t0)
        assert equal, "a driver put arrived changed"
        del ref
    assert landed == ("cuda:0" if on_card else "cpu"), landed
    written = want.clone()
    ref = rt.put(written)
    written.add_(1)   # raylint: allow(jit-stability) the write is the check: get must refuse the ref
    try:
        rt.get(keeper.matches.remote(ref), timeout=300)
    except rt.RayTpuError as e:
        assert "modified in place" in str(e), e
    else:
        raise AssertionError("a put tensor written in place crossed over")
    del ref, written, got
    rt.kill(keeper)
    log(f"[process-runtime] (b) a seeded bf16 [{side}, {side}] tensor made "
        f"in the daemon arrived on the driver's {want.device} bit-equal to "
        f"the same seeded build here; a driver put arrived on the daemon's "
        f"{landed} bit-equal; a put tensor written in place was refused "
        f"across processes")
    log(f"[times] {card}: tensor hops of {nbytes} bytes (host clock, median "
        f"of {HOP_RUNS}): daemon -> driver "
        f"{statistics.median(from_daemon) * 1e3:.1f} ms, driver -> daemon "
        f"{statistics.median(to_daemon) * 1e3:.1f} ms (a task round trip "
        f"each)")
    del want

    # (c) phase 5's deployment in a GPU actor of the daemon
    from ray_tpu_torch.models import transformer
    _, lengths, requests, cfg32, params = serve_inputs(device, width,
                                                       n_requests)
    n_layers, n_tokens = cfg32.n_layers, int(lengths.sum())
    host = _torch_tree_to_numpy(params)
    t0 = time.perf_counter()
    params_ref = rt.put(host)
    put_s = time.perf_counter() - t0
    server_cls = rt.remote(num_gpus=gpus, max_concurrency=n_requests)(
        DaemonLM)
    server = server_cls.remote(cfg32, [params_ref], device)
    (fetch_s, fetched), server_pid, granted = rt.get(server.loaded.remote(),
                                                     timeout=300)
    assert server_pid == pid and fetched == _tree_nbytes(host), (
        server_pid, fetched)
    call = rt.ActorMethod(server, "__call__")
    counted = 0

    def counts():
        nonlocal counted
        launches, batches = rt.get(server.counts.remote(), timeout=60)
        if on_card:
            assert launches == n_layers * batches, (launches, batches)
        counted += launches
        return batches

    def one_thread():
        t0 = time.perf_counter()
        answers = rt.get([call.remote(r) for r in requests], timeout=600)
        return answers, time.perf_counter() - t0

    def threads():
        return serve_all(lambda r: rt.get(call.remote(r), timeout=600),
                         requests)

    rt.get(server.reset_counts.remote(), timeout=60)
    ans32, _ = one_thread()
    batches = counts()
    check_dense(cfg32, params, requests, ans32, device)
    log(f"[process-runtime] (c) the driver put the f32 weights as host numpy"
        f" ({_tree_nbytes(host)} bytes, {put_s:.2f} s); the actor in the "
        f"daemon (pid {server_pid}, granted {granted}) fetched them over the "
        f"object plane: {fetched} bytes in {fetch_s:.2f} s; f32: "
        f"{n_requests} answers in {batches} batches match the unpadded dense"
        f" run at rtol=atol=1e-3; kernel launches {n_layers} per batch, "
        f"counted in the daemon's process")
    rt.get(server.switch.remote("bfloat16"), timeout=600)
    threads()                                             # warm-up
    measured = {}
    for what, submit in ((f"from {n_requests} threads", threads),
                         ("from one thread", one_thread)):
        rt.get(server.reset_counts.remote(), timeout=60)
        runs = [submit() for _ in range(SERVE_RUNS)]
        batches = counts()
        for answers, _ in runs:
            assert all(np.isfinite(a).all() for a in answers), \
                "non-finite logits"
            assert all(a.shape == (width["vocab_size"],) for a in answers)
        measured[what] = (statistics.median(t for _, t in runs), batches)
    log(f"[process-runtime] (c) bf16 after the switch: {n_requests} finite "
        f"answers x {SERVE_RUNS} passes from {n_requests} threads and x "
        f"{SERVE_RUNS} from one; kernel launches {n_layers} per batch in the "
        f"daemon, {counted} in all")
    for what, (seconds, batches) in measured.items():
        log(f"[times] {card}: bf16 serving from a num_gpus={gpus} actor in a "
            f"daemon process {what} {n_requests / seconds:.2f} requests/s, "
            f"{n_tokens / seconds:.0f} tokens/s (median of {SERVE_RUNS} "
            f"passes, {seconds:.4f} s, {batches} batches)")
    log(f"[times] {card}: beside phase 5 direct {rates['direct']:.2f}, phase"
        f" 15 in-process actor {rates['actor']:.2f}, phase 16 Serve plane "
        f"{rates['plane_threads']:.2f} (16 threads) / "
        f"{rates['plane_single']:.2f} (one thread) requests/s")
    free_serving = torch.cuda.mem_get_info(device)[0]

    # (d) the GPU daemon dies
    gpu_addr = cluster.daemons[gpu_index]["address"]
    timeout_s = cluster._heartbeat_timeout_ms / 1e3
    t0 = time.perf_counter()
    cluster.kill_daemon(gpu_index)
    try:
        rt.get(server.counts.remote(), timeout=60)
    except rt.ActorDiedError as e:
        died_s = time.perf_counter() - t0
        reason = str(e).splitlines()[0][:120]
    else:
        raise AssertionError("a call on the killed daemon's actor returned")
    assert died_s <= timeout_s, (died_s, timeout_s)
    state = worker.global_worker().runtime.state
    deadline = time.monotonic() + timeout_s + 5
    dead = None
    while time.monotonic() < deadline:
        dead = [n for n in state.list_nodes() if n.address == gpu_addr]
        if dead and not dead[0].alive:
            break
        time.sleep(0.1)
    assert dead and not dead[0].alive, dead
    del params, ans32
    free_after = None
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        free_device_caches()
        free_after = torch.cuda.mem_get_info(device)[0]
        if free_before - free_after <= PROCESS_MEMORY_SLACK:
            break
        time.sleep(0.2)
    assert free_before - free_after <= PROCESS_MEMORY_SLACK, (
        free_before, free_after)
    log(f"[process-runtime] (d) kill_daemon: a call on the actor raised "
        f"ActorDiedError after {died_s:.2f} s (heartbeat timeout "
        f"{timeout_s:.1f} s): {reason!r}; the state service lists the node "
        f"dead ({dead[0].death_reason!r}); the card's free memory: "
        f"{free_before} bytes before (a), {free_serving} while the daemon "
        f"served, {free_after} after the kill")
    t0 = time.perf_counter()
    cluster.add_daemon(num_gpus=gpus)
    new = cluster.daemons[-1]
    procs.append(new["proc"])
    assert new["cards"] == cards, (new["cards"], cards)
    server = server_cls.remote(cfg32, [params_ref], device)
    call = rt.ActorMethod(server, "__call__")
    batch = requests[:BATCH_BUCKETS[-1]]
    answers = rt.get([call.remote(r) for r in batch], timeout=600)
    params = _numpy_tree_to_torch(host, device)
    check_dense(cfg32, params, batch, answers, device)
    rt.kill(server)
    del params
    log(f"[process-runtime] (d) a new add_daemon(num_gpus={gpus}) took the "
        f"freed card {new['cards']}; a fresh actor there answered "
        f"{len(batch)} f32 requests matching the dense run at 1e-3 "
        f"({time.perf_counter() - t0:.2f} s)")
    return counted, {what: n_requests / seconds
                     for what, (seconds, _) in measured.items()}


# -- phase 19: the tensor plane; training and serving in daemons -------------


class PlaneRank:
    """User code for phase 19 (c) and (d): one rank of a collective group
    in a daemon process. Each op returns its result as host numpy (bf16 as
    f32) with the op's ms, timed here on the host clock."""

    def plane(self):
        import os

        from ray_tpu_torch.collective.tensor_plane import current_plane
        return current_plane(), os.getpid()

    def op(self, name, x, **kw):
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.collective.tensor_plane import current_plane
        device = torch.device(current_plane()["device"])
        args = () if x is None else (torch.as_tensor(x).to(device),)
        t0 = time.perf_counter()
        out = getattr(col, name)(*args, group_name=kw.pop("group"), **kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if out is None:
            return None, str(device), ms
        assert out.device == device, (out.device, device)
        return out.float().cpu().numpy(), str(device), ms

    def send(self, seed, n, peer, group):
        from ray_tpu_torch import collective as col
        x = torch.randn(n, generator=torch.Generator().manual_seed(seed))
        t0 = time.perf_counter()
        col.send(x.reshape(-1, 1024), peer, group)
        return (time.perf_counter() - t0) * 1e3

    def recv(self, seed, n, peer, group):
        """Whether the tensor received equals the seeded build here, bit
        for bit, and the recv's ms."""
        from ray_tpu_torch import collective as col
        t0 = time.perf_counter()
        got = col.recv(peer, group)
        ms = (time.perf_counter() - t0) * 1e3
        want = torch.randn(n, generator=torch.Generator().manual_seed(seed))
        return torch.equal(got.cpu(), want.reshape(-1, 1024)), ms

    def destroy(self, group):
        from ray_tpu_torch import collective as col
        col.destroy_collective_group(group)


class CheckpointLM(ServedLM):
    """User code for phase 19 (b): phase 16's deployment whose weights come
    from the checkpoint engine: the replica receives (a)'s committed
    parameters as ``checkpoint=`` (host numpy, loaded on the replica) and
    casts them to its config's dtype on its card. Its forward launches are
    counted in its own process."""

    def __init__(self, cfg, answer, device, checkpoint):
        import ray_tpu_torch
        from ray_tpu_torch.models import transformer
        granted = ray_tpu_torch.get_runtime_context().get_gpu_devices()
        dev = granted[0] if granted else device
        params = _numpy_tree_to_torch(checkpoint["params"], dev)
        if cfg.dtype != torch.float32:
            params = transformer.cast_params(params, cfg.dtype)
        super().__init__(cfg, params, answer, device)
        self.fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    def counts(self):
        """(forward launches in this process, batches answered)."""
        return self.fa.launches, len(self.sizes)


def plane_trainer_loop(config):
    """Phase 19 (a): the training loop a user hands ``TorchTrainer``, run by
    a worker inside a GPU daemon. It checks that it joined the tensor plane
    (NCCL, world 1) and got its mesh, builds phase 9's model from phase 9's
    seed on its granted card, takes ``config["steps"]`` steps on
    ``session.shard_batch``, reports each, and at the last step reports the
    parameters as a checkpoint (the engine commits them). A final report
    carries what only this process can measure: each report's ms, the
    kernels' launches counted here, the commit's time."""
    import os

    from torch.distributed.tensor import DTensor

    import ray_tpu_torch
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.collective.tensor_plane import current_plane
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.observability import perf
    from ray_tpu_torch.train import make_lm_train_step, session

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    granted = ray_tpu_torch.get_runtime_context().get_gpu_devices()
    assert granted and granted[0].type == "cuda", granted
    device = granted[0]
    plane, mesh = current_plane(), session.get_mesh()
    assert plane is not None and plane["backend"] == "nccl" \
        and plane["world"] == 1 and plane["device"] == str(device), plane
    assert mesh is not None and mesh.device_type == "cuda" \
        and mesh.size == 1, mesh
    cfg = TransformerConfig(**config["width"], dtype=torch.bfloat16,
                            use_flash=True)
    init_fn, step_fn, _ = make_lm_train_step(cfg, mesh, device=device)
    state = init_fn(torch.Generator(device=device).manual_seed(
        config["seed"]))
    tokens = session.shard_batch(config["tokens"])
    perf.enable()
    perf.reset()
    aw = adamw_ops()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    aw.adamw_launches = 0
    report_ms = []
    for step in range(config["steps"]):
        before = launch_counts(fa)
        adamw_before = aw.adamw_launches
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        loss = metrics["loss"].item()
        grad_norm = metrics["grad_norm"].item()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launched = tuple(a - b for a, b in zip(launch_counts(fa), before))
        ckpt = None
        if step == config["steps"] - 1:
            ckpt = Checkpoint.from_dict({"params": transformer._tree_map(
                lambda p: p.to_local() if isinstance(p, DTensor) else p,
                state[0])})
        t1 = time.perf_counter()
        session.report({"step": step, "loss": loss, "grad_norm": grad_norm,
                        "step_ms": step_ms, "launches": launched,
                        "adamw_launches": aw.adamw_launches - adamw_before,
                        "adamw_per_step": adamw_per_step(state[1])},
                       checkpoint=ckpt)
        report_ms.append((time.perf_counter() - t1) * 1e3)
    t0 = time.perf_counter()
    committed = session._get_session()._engine().flush(timeout=600)
    flush_s = time.perf_counter() - t0
    snap = perf.snapshot()
    perf.disable()
    session.report({"summary": True, "report_ms": report_ms,
                    "launches": launch_counts(fa),
                    "adamw_launches": aw.adamw_launches,
                    "committed": committed,
                    "flush_s": flush_s,
                    "enqueue_ms": _perf_mean_ms(snap, "train.ckpt_enqueue"),
                    "save_ms": _perf_mean_ms(snap, "ckpt.save"),
                    "pid": os.getpid(), "plane": plane,
                    "mesh": dict(mesh.shape),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})


def tensor_plane_phase(fa, device, card, phase9, phase17_ms, rates,
                       width=SERVE_WIDTH, batch=TRAIN_BATCH,
                       steps=TRAIN_STEPS, n_requests=N_REQUESTS):
    """Phase 19: the tensor plane, ``TorchTrainer`` workers training in a
    GPU daemon, and a Serve deployment in that daemon from their
    checkpoint. ``phase9``: phase 9's results (its first loss and step ms);
    ``phase17_ms``: phase 17 (a)'s step ms; ``rates``: phases 16 and 18's
    bf16 requests/s. Returns the launches counted in the daemon: (forward,
    dq, dkv) of (a) plus (b)'s forward, and (a)'s AdamW launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import ProcessCluster

    root = REPO / PLANE_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free_device_caches()
    free_before = torch.cuda.mem_get_info(device)[0]
    cluster = ProcessCluster(num_daemons=1, num_cpus=4,
                             heartbeat_timeout_ms=PLANE_HEARTBEAT_TIMEOUT_MS)
    procs = [cluster.state_proc]
    try:
        gpu_index = len(cluster.daemons)
        cluster.add_daemon(num_gpus=1)
        procs += [d["proc"] for d in cluster.daemons]
        rt.init(address=cluster.address)
        try:
            launches, adamw_launches = tensor_plane_paths(
                rt, serve, cluster, gpu_index, fa, device, card, phase9,
                phase17_ms, rates, root, width, batch, steps, n_requests,
                procs)
        finally:
            serve.shutdown()
            rt.shutdown()
    finally:
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    # (e) nothing of the cluster outlives it, and the card's memory is back
    procs += [d["proc"] for d in cluster.daemons]
    left = [p.pid for p in procs if p.poll() is None]
    assert not left, left
    free_after = None
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        free_device_caches()
        free_after = torch.cuda.mem_get_info(device)[0]
        if free_before - free_after <= PROCESS_MEMORY_SLACK:
            break
        time.sleep(0.2)
    assert free_before - free_after <= PROCESS_MEMORY_SLACK, (
        free_before, free_after)
    log(f"[plane] (e) serve.shutdown(), shutdown() and cluster.shutdown(): "
        f"none of the {len(set(procs))} state-service and daemon processes"
        f" is left; the card's free memory {free_before} bytes before (a), "
        f"{free_after} after; the checkpoint directory is deleted")
    return launches, adamw_launches


def plane_dataset_steps(rt, card, phase9, width, batch,
                        steps=PLANE_DATASET_STEPS):
    """Phase 19 (a), continued: ``TorchTrainer(datasets={"train": ds})``
    with one ``use_gpu`` worker in the GPU daemon. ``ds`` holds ``steps``
    int32 blocks of phase 9's batch shape (block 0 phase 9's batch),
    put by this driver; the worker's ``DataIterator`` is pickled to the
    daemon, which fetches the blocks over the object plane, and the loop
    (phase 20 (b)'s) reads them through ``iter_device_batches``. Step 0's
    loss equals phase 9's. Returns the launches counted in the daemon."""
    import ray_tpu_torch.data  # noqa: F401
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import TorchTrainer

    n = width["n_layers"]
    per_step = (2 * n, n, n)
    first = np.random.default_rng(SEED + 4).integers(
        0, width["vocab_size"], size=batch)
    rest = np.random.default_rng(SEED + 20).integers(
        0, width["vocab_size"], size=((steps - 1) * batch[0], batch[1]))
    blocks = np.split(np.concatenate([first, rest]).astype(np.int32), steps)
    ds = rt.data.from_numpy(blocks)
    trainer = TorchTrainer(
        data_trainer_loop, train_loop_config=dict(
            width=width, device="cuda", seed=SEED, batch=batch[0],
            blocks=blocks),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        datasets={"train": ds}, results_timeout_s=TRAINER_TIMEOUT_S)
    t0 = time.perf_counter()
    result = trainer.fit()
    fit_s = time.perf_counter() - t0
    assert result.error is None, result.error
    hist = result.metrics_history
    assert [m["step"] for m in hist] == list(range(steps)), hist
    losses = [m["loss"] for m in hist]
    assert all(np.isfinite(losses)), losses
    np.testing.assert_allclose(losses[0], phase9["losses"][0],
                               rtol=TRAIN_RTOL)
    assert all(m["launches"] == per_step for m in hist), \
        [m["launches"] for m in hist]
    assert all(m["equal"] and m["shape"] == batch and m["dtensor"]
               and m["device"] == "cuda" for m in hist), hist
    log(f"[plane] (a) TorchTrainer(datasets={{'train': ds}}), 1 use_gpu "
        f"worker in the GPU daemon: {steps} int32 blocks of {batch[0]} x "
        f"{batch[1]} put by the driver and fetched by the daemon, read "
        f"through iter_device_batches: every batch a CUDA DTensor equal to "
        f"its block; losses {losses} (step 0 vs phase 9's "
        f"{phase9['losses'][0]} at rtol {TRAIN_RTOL}); launches a step "
        f"{per_step} counted in the daemon; steps in ms "
        + ", ".join(f"{m['step_ms']:.1f}" for m in hist)
        + f"; fit() {fit_s:.1f} s ({card})")
    return tuple(steps * c for c in per_step)


def tensor_plane_paths(rt, serve, cluster, gpu_index, fa, device, card,
                       phase9, phase17_ms, rates, root, width, batch, steps,
                       n_requests, procs):
    """Phase 19 (a)-(d) on a live cluster, with this process its driver."""
    from ray_tpu_torch.air import CheckpointConfig, RunConfig, ScalingConfig
    from ray_tpu_torch.checkpoint import CheckpointRef, resolve_latest
    from ray_tpu_torch.collective import create_collective_group
    from ray_tpu_torch.collective.collective_group.nccl_process_group import (
        P2P_NS)
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import TorchTrainer
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    n = width["n_layers"]
    per_step = (2 * n, n, n)
    # (a) TorchTrainer: one use_gpu worker in the GPU daemon
    config = dict(width=width, seed=SEED, steps=1 + steps,
                  tokens=np.random.default_rng(SEED + 4).integers(
                      0, width["vocab_size"], size=batch))
    trainer = TorchTrainer(
        plane_trainer_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="plane", storage_path=str(root),
                             checkpoint_config=CheckpointConfig(
                                 num_to_keep=1)),
        results_timeout_s=TRAINER_TIMEOUT_S)
    t0 = time.perf_counter()
    result = trainer.fit()
    fit_s = time.perf_counter() - t0
    if result.error is not None:
        state = rt._private.worker.global_worker().runtime.state
        log("[plane] (a) failed; nodes: " + "; ".join(
            f"{n.address} alive={n.alive} {n.death_reason!r}"
            for n in state.list_nodes()))
    assert result.error is None, result.error
    hist = [m for m in result.metrics_history if "summary" not in m]
    summary = next(m for m in result.metrics_history if "summary" in m)
    assert [m["step"] for m in hist] == list(range(1 + steps)), hist
    losses = [m["loss"] for m in hist]
    norms = [m["grad_norm"] for m in hist]
    assert all(np.isfinite(losses + norms)), (losses, norms)
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses[0], phase9["losses"][0],
                               rtol=TRAIN_RTOL)
    assert all(m["launches"] == per_step for m in hist), \
        [m["launches"] for m in hist]
    launches = tuple(summary["launches"])
    assert launches == tuple((1 + steps) * c for c in per_step), launches
    assert all(m["adamw_launches"] == m["adamw_per_step"] for m in hist), \
        [(m["adamw_launches"], m["adamw_per_step"]) for m in hist]
    adamw_launches = summary["adamw_launches"]
    assert adamw_launches == sum(m["adamw_per_step"] for m in hist), \
        adamw_launches
    cards = cluster.daemons[gpu_index]["cards"]
    assert summary["pid"] == cluster.daemons[gpu_index]["proc"].pid and \
        summary["visible"] == ",".join(cards), summary
    assert summary["committed"], "the engine did not commit the parameters"
    step_ms = statistics.median(m["step_ms"] for m in hist[1:])
    ckpt_root = root / "plane" / "checkpoints"
    ref = CheckpointRef(str(ckpt_root), resolve_latest(str(ckpt_root)))
    log(f"[plane] (a) TorchTrainer, 1 use_gpu worker in the GPU daemon (pid "
        f"{summary['pid']}, CUDA_VISIBLE_DEVICES={summary['visible']!r}) on "
        f"the tensor plane {summary['plane']}, mesh {summary['mesh']}: bf16,"
        f" {n} layers, remat, batch {batch[0]} x {batch[1]}: losses "
        f"{losses} (step 0 against phase 9's {phase9['losses'][0]} at "
        f"rtol {TRAIN_RTOL}), grad norms {norms}; launches a step "
        f"{per_step} (forward, dq, dkv) and {hist[0]['adamw_per_step']} "
        f"AdamW counted in the daemon's process, {launches} and "
        f"{adamw_launches} in {1 + steps} steps; the parameters committed as "
        f"{ref.manifest_name}; fit() {fit_s:.1f} s")
    log(f"[times] {card}: TorchTrainer bf16 step in a GPU daemon "
        f"{step_ms:.3f} ms (median of {steps}; steps in ms: "
        + ", ".join(f"{m['step_ms']:.1f}" for m in hist)
        + f"), phase 9's direct step {phase9['step_ms']:.3f} ms, phase 17 "
        f"(a)'s in-process trainer step {phase17_ms:.3f} ms in this run; "
        f"session.report "
        f"{statistics.median(summary['report_ms'][:-1]):.3f} ms without a "
        f"checkpoint (median of {steps}), {summary['report_ms'][-1]:.1f} ms"
        f" with the parameters (the host snapshot and the engine's enqueue "
        f"{summary['enqueue_ms']:.1f} ms); the commit (hash, write, "
        f"manifest) {summary['save_ms'] / 1e3:.3f} s, waited "
        f"{summary['flush_s']:.3f} s after the last report")

    # (a) continued: TorchTrainer(datasets=) with its worker in the GPU
    # daemon, fed by a dataset whose blocks the daemon fetches
    launches = tuple(a + b for a, b in zip(launches, plane_dataset_steps(
        rt, card, phase9, width, batch)))

    # (b) serve.run from the CheckpointRef: a num_gpus=1 replica in the
    # GPU daemon
    _, lengths, requests = seeded_requests(width, n_requests)
    cfg32 = TransformerConfig(**width, dtype=torch.float32, use_flash=True)
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    n_tokens = int(lengths.sum())
    lm = serve.deployment(
        CheckpointLM, name="lm19", max_batch_size=8,
        batch_wait_timeout_s=0.01, pad_batch_to=BATCH_BUCKETS,
        target_latency_ms=SERVE_BUDGET_MS, ray_actor_options={"num_gpus": 1},
        checkpoint=dataclasses.asdict(ref))
    t0 = time.perf_counter()
    h = serve.run(lm.bind(cfg32, "numpy", device), route_prefix=None)
    run_s = time.perf_counter() - t0
    assert h.devices.remote().result(timeout=60) == [
        torch.device("cuda", 0)]
    counted = 0

    def served(run):
        """``run()`` under the replica's own counts: (its result, batches);
        the forward launches it made in the daemon go into ``counted``."""
        nonlocal counted
        l0, b0 = h.counts.remote().result(timeout=60)
        out = run()
        l1, b1 = h.counts.remote().result(timeout=60)
        assert l1 - l0 == n * (b1 - b0), (l1 - l0, b1 - b0)
        counted += l1 - l0
        return out, b1 - b0

    (answers, _), ran = served(lambda: serve_all(
        lambda r: h.remote(r).result(timeout=300), requests))
    params = _numpy_tree_to_torch(ref.load()["params"], device)
    check_dense(cfg32, params, requests, answers, device)
    del params
    log(f"[plane] (b) serve.run from the dict form of (a)'s CheckpointRef "
        f"returned in {run_s:.2f} s: a num_gpus=1 replica in the GPU daemon "
        f"loaded the committed parameters; f32: {n_requests} answers in "
        f"{ran} batches match a dense forward here on the same checkpoint "
        f"at rtol=atol=1e-3; kernel launches {n} per batch, counted in the "
        f"daemon")
    h.shutdown()
    serve.delete("lm19")
    h = serve.run(lm.bind(cfg16, "numpy", device), route_prefix=None)
    serve_all(lambda r: h.remote(r).result(timeout=300), requests)  # warm-up

    def threads():
        return serve_all(lambda r: h.remote(r).result(timeout=300), requests)

    def one_thread():
        t0 = time.perf_counter()
        responses = [h.remote(r) for r in requests]
        answers = [r.result(timeout=300) for r in responses]
        return answers, time.perf_counter() - t0

    measured = {}
    for what, submit in ((f"from {n_requests} threads", threads),
                         ("from one thread", one_thread)):
        runs, batches = served(lambda: [submit()
                                        for _ in range(SERVE_RUNS)])
        for answers, _ in runs:
            assert all(np.isfinite(a).all() for a in answers), \
                "non-finite logits"
            assert all(a.shape == (width["vocab_size"],) for a in answers)
        measured[what] = (statistics.median(t for _, t in runs), batches)
    h.shutdown()
    serve.delete("lm19")      # its replica's card is (d)'s
    log(f"[plane] (b) bf16 from the same checkpoint (the f32 deployment "
        f"deleted, a bf16 one run): {n_requests} finite answers x "
        f"{SERVE_RUNS} passes from {n_requests} threads and x {SERVE_RUNS} "
        f"from one; forward launches in the daemon {counted} in all")
    for what, (secs, batches) in measured.items():
        log(f"[times] {card}: bf16 serving from a Serve replica in a daemon, "
            f"deployed from a CheckpointRef, {what} "
            f"{n_requests / secs:.2f} requests/s, {n_tokens / secs:.0f} "
            f"tokens/s (median of {SERVE_RUNS} passes, {secs:.4f} s, "
            f"{batches} batches)")
    log(f"[times] {card}: beside phase 16's in-process Serve plane "
        f"{rates['plane_threads']:.2f} / {rates['plane_single']:.2f} and "
        f"phase 18 (c)'s actor in a daemon {rates['daemon_threads']:.2f} / "
        f"{rates['daemon_single']:.2f} requests/s (16 threads / one)")
    launches = (launches[0] + counted,) + launches[1:]

    # (c) a gloo plane over two CPU daemons
    cluster.add_daemon()
    procs.append(cluster.daemons[-1]["proc"])
    state = rt._private.worker.global_worker().runtime.state
    cpu_addrs = [d["address"] for d in cluster.daemons if not d["cards"]]
    nodes = {i.address: i.node_id.hex() for i in state.list_nodes()
             if i.alive}
    rank_cls = rt.remote(num_cpus=1)(PlaneRank)
    ranks = [rank_cls.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=nodes[a], soft=False)).remote() for a in cpu_addrs[:2]]
    group = "plane-cpu"
    t0 = time.perf_counter()
    create_collective_group(ranks, 2, [0, 1], backend="nccl",
                            group_name=group)
    form_s = time.perf_counter() - t0
    planes = rt.get([r.plane.remote() for r in ranks], timeout=120)
    assert [p["backend"] for p, _ in planes] == ["gloo", "gloo"] and \
        len({pid for _, pid in planes}) == 2, planes
    rng = np.random.default_rng(SEED + 19)
    xs = [rng.standard_normal((4, 1024)).astype(np.float32) for _ in range(2)]
    expect = {
        "allreduce": ({}, [xs[0] + xs[1]] * 2),
        "reduce": ({"dst_rank": 1}, [xs[0], xs[0] + xs[1]]),
        "broadcast": ({"src_rank": 1}, [xs[1], xs[1]]),
        "allgather": ({}, [np.stack(xs)] * 2),
        "reducescatter": ({}, [(xs[0] + xs[1])[:2], (xs[0] + xs[1])[2:]]),
        "barrier": ({}, [None, None]),
    }
    op_ms = {}
    for name, (kw, want) in expect.items():
        args = [None, None] if name == "barrier" else xs
        outs = rt.get([r.op.remote(name, x, group=group, **kw)
                       for r, x in zip(ranks, args)], timeout=120)
        for (got, where, _), w in zip(outs, want):
            assert where == "cpu", where
            if w is None:
                assert got is None
            else:
                np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)
        op_ms[name] = max(ms for _, _, ms in outs)
    hops = []
    for src, dst in ((0, 1), (1, 0)):
        seed = SEED + 20 + src
        got = ranks[dst].recv.remote(seed, PLANE_BULK_ELEMS, src, group)
        sent_ms = rt.get(ranks[src].send.remote(seed, PLANE_BULK_ELEMS, dst,
                                                group), timeout=120)
        equal, recv_ms = rt.get(got, timeout=120)
        assert equal, f"the bulk lane changed the tensor {src} -> {dst}"
        hops.append((sent_ms, recv_ms))
    rt.get([r.destroy.remote(group) for r in ranks], timeout=60)
    left = [k for k in state.kv_keys(namespace=P2P_NS)
            if k.startswith(group.encode())]
    assert left == [], left
    for r in ranks:
        rt.kill(r)
    log(f"[plane] (c) a gloo plane over two CPU daemons (pids "
        f"{[pid for _, pid in planes]}), formed in {form_s:.2f} s: "
        f"allreduce, reduce, broadcast, allgather, reducescatter and barrier "
        f"on seeded [4, 1024] f32 tensors match numpy; "
        f"{PLANE_BULK_ELEMS * 4} bytes sent on the bulk lane each way arrived"
        f" bit-equal; nothing of the group is left under {P2P_NS!r}")
    log(f"[times] {card}: gloo plane op ms (host clock, slower rank): "
        + ", ".join(f"{k} {v:.3f}" for k, v in op_ms.items())
        + "; bulk lane " + ", ".join(
            f"{a}->{b} send {s:.1f} / recv {r:.1f}" for (a, b), (s, r) in
            zip(((0, 1), (1, 0)), hops)))

    # (d) an NCCL plane over two GPU daemons on distinct cards
    if torch.cuda.device_count() < 2:
        log(f"[plane] (d) did not run: an NCCL plane over distinct cards "
            f"needs two or more, this machine has "
            f"{torch.cuda.device_count()}")
        return launches, adamw_launches
    cluster.add_daemon(num_gpus=1)
    procs.append(cluster.daemons[-1]["proc"])
    gpu_addrs = [d["address"] for d in cluster.daemons if d["cards"]
                 and d["proc"].poll() is None]
    nodes = {i.address: i.node_id.hex() for i in state.list_nodes()
             if i.alive}
    ranks = [rt.remote(num_gpus=1)(PlaneRank).options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=nodes[a], soft=False)).remote() for a in gpu_addrs[:2]]
    create_collective_group(ranks, 2, [0, 1], backend="nccl",
                            group_name="plane-gpu")
    outs = rt.get([r.op.remote("allreduce", x, group="plane-gpu")
                   for r, x in zip(ranks, xs)], timeout=120)
    for got, where, _ in outs:
        assert where == "cuda:0", where
        np.testing.assert_allclose(got, xs[0] + xs[1], rtol=1e-6, atol=1e-6)
    rt.get([r.destroy.remote("plane-gpu") for r in ranks], timeout=60)
    for r in ranks:
        rt.kill(r)
    log(f"[plane] (d) an NCCL plane over two GPU daemons on cards "
        f"{[d['cards'] for d in cluster.daemons if d['cards']]}: allreduce "
        f"matches numpy; ms {[round(ms, 3) for _, _, ms in outs]}")
    return launches, adamw_launches


# -- phase 20: the data plane --------------------------------------------------


def row_logits(cfg, params, batch):
    """f32 logits at each row's last real token, ``batch["length"] - 1``."""
    return last_token_logits(cfg, params, {"tokens": batch["tokens"],
                                           "last": batch["length"] - 1})


def data_rows(width=SERVE_WIDTH, n_rows=DATA_ROWS):
    """Phase 20 (a)'s rows: phase 5's kind of seeded requests, right-padded
    to ``max_seq_len``, as dicts ``{"tokens", "length"}``. Returns
    (lengths, requests, rows)."""
    _, lengths, requests = seeded_requests(width, n_rows)
    rows = []
    for r in requests:
        tokens = np.zeros(width["max_seq_len"], np.int64)
        tokens[:len(r)] = r
        rows.append({"tokens": tokens, "length": len(r)})
    return lengths, requests, rows


def counting_predictor():
    """``TorchPredictor`` whose builds are counted (``builds``)."""
    from ray_tpu_torch.air import TorchPredictor
    lock = threading.Lock()

    class CountingPredictor(TorchPredictor):
        builds = 0

        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            with lock:
                cls.builds += 1
            return super().from_checkpoint(checkpoint, **kwargs)

    return CountingPredictor


def batch_predict(rt, fa, ds, cfg, params, device, n_batches):
    """One ``BatchPredictor.predict`` over ``ds``: (predictions [rows,
    vocab], the kept lengths, seconds, forward launches). The predictor
    must be built once and launch n_layers kernels per batch."""
    from ray_tpu_torch.air import BatchPredictor, Checkpoint
    predictor_cls = counting_predictor()
    bp = BatchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": params}), predictor_cls,
        apply_fn=functools.partial(row_logits, cfg), device=device)
    fa.launches = 0
    t0 = time.perf_counter()
    out = bp.predict(ds, batch_size=DATA_BATCH,
                     feature_columns=["tokens", "length"],
                     keep_columns=["length"]).to_pandas()
    seconds = time.perf_counter() - t0
    launches = fa.launches
    assert predictor_cls.builds == 1, predictor_cls.builds
    assert launches == cfg.n_layers * n_batches, (launches, n_batches)
    assert list(out.columns) == ["length", "predictions"], out.columns
    return (np.stack(out["predictions"].tolist()),
            out["length"].to_numpy(), seconds, launches)


def batch_predictor_phase(rt, fa, device, card, direct, width=SERVE_WIDTH,
                          n_rows=DATA_ROWS):
    """Phase 20 (a). ``direct``: phase 5's (requests/s, tokens/s). Returns
    the forward launches of its runs."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    lengths, requests, rows = data_rows(width, n_rows)
    ds = rt.data.from_items(rows, parallelism=DATA_BLOCKS)
    assert ds.num_blocks() == DATA_BLOCKS and ds.columns() == [
        "tokens", "length"], ds
    # map_batches cuts each block into batches of DATA_BATCH rows
    n_batches = sum(math.ceil(len(rt.get(r)) / DATA_BATCH)
                    for r in ds.get_internal_block_refs())
    cfg32 = TransformerConfig(**width, dtype=torch.float32, use_flash=True)
    params = transformer.init_params(
        cfg32, torch.Generator(device=device).manual_seed(SEED), device)
    preds, kept, seconds32, total = batch_predict(rt, fa, ds, cfg32, params,
                                                  device, n_batches)
    assert preds.shape == (n_rows, width["vocab_size"]), preds.shape
    assert kept.tolist() == lengths.tolist()
    check_dense(cfg32, params, requests[:DATA_CHECKED],
                preds[:DATA_CHECKED], device)
    log(f"[data] (a) {n_rows} rows of 1..{width['max_seq_len']} tokens "
        f"(lengths {lengths.tolist()}), padded to {width['max_seq_len']}, "
        f"tabular over {DATA_BLOCKS} blocks; BatchPredictor, f32: the "
        f"first {DATA_CHECKED} rows match the unpadded dense run at "
        f"rtol=atol=1e-3; predictor built once; {total} forward launches "
        f"in {n_batches} batches ({seconds32:.2f} s)")
    cfg16 = TransformerConfig(**width, dtype=torch.bfloat16, use_flash=True)
    params16 = transformer.cast_params(params, torch.bfloat16)
    del params
    runs = []
    for i in range(1 + SERVE_RUNS):
        preds16, _, seconds, launches = batch_predict(
            rt, fa, ds, cfg16, params16, device, n_batches)
        assert np.isfinite(preds16).all(), "non-finite logits"
        total += launches
        if i:
            runs.append(seconds)
    seconds = statistics.median(runs)
    n_tokens = int(lengths.sum())
    log(f"[times] {card}: BatchPredictor bf16 {n_rows / seconds:.2f} "
        f"rows/s, {n_tokens / seconds:.0f} real tokens/s (median of "
        f"{SERVE_RUNS} runs of {n_rows} rows, {n_tokens} real tokens each, "
        f"{seconds:.4f} s; runs in s: "
        + ", ".join(f"{t:.4f}" for t in runs)
        + f"); phase 5 direct {direct[0]:.2f} requests/s, {direct[1]:.0f} "
        f"tokens/s in this run; every run's {n_rows} rows finite, the "
        f"predictor built once a run, {cfg16.n_layers} forward launches a "
        f"batch")
    return total


def data_trainer_loop(config):
    """Phase 20 (b): the loop a user hands ``TorchTrainer(datasets=)``. It
    builds ``make_lm_train_step`` on the session's mesh from
    ``config["seed"]``'s weights and takes one step on every batch of its
    dataset shard, read through ``iter_device_batches`` (sharded over the
    mesh, two batches prefetched), reporting each."""
    from torch.distributed.tensor import DTensor
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.parallel import batch_sharding
    from ray_tpu_torch.train import make_lm_train_step, session

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    device = torch.device(config["device"])
    cfg = TransformerConfig(**config["width"], dtype=torch.bfloat16,
                            use_flash=True)
    mesh = session.get_mesh()
    if device.type == "cuda":
        assert mesh is not None and set(mesh.shape.values()) == {1}, mesh
    init_fn, step_fn, _ = make_lm_train_step(cfg, mesh, device=device)
    state = init_fn(torch.Generator(device=device).manual_seed(
        config["seed"]))
    batches = session.get_dataset_shard("train").iter_device_batches(
        batch_size=config["batch"], drop_last=True, device=device,
        sharding=None if mesh is None else (mesh, batch_sharding(mesh)),
        prefetch_batches=2)
    for step, batch in enumerate(batches):
        tokens = batch["value"]
        before = launch_counts(fa)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        loss = metrics["loss"].item()
        grad_norm = metrics["grad_norm"].item()
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launched = tuple(a - b for a, b in zip(launch_counts(fa), before))
        local = tokens.to_local() if isinstance(tokens, DTensor) else tokens
        want = config["blocks"][step]
        session.report({
            "step": step, "loss": loss, "grad_norm": grad_norm,
            "step_ms": step_ms, "launches": launched,
            "dtensor": isinstance(tokens, DTensor),
            "device": local.device.type, "shape": tuple(tokens.shape),
            "equal": bool(np.array_equal(local.cpu().numpy(), want))})


def data_trainer_phase(rt, fa, device, card, phase9, phase17_ms,
                       width=SERVE_WIDTH, batch=TRAIN_BATCH,
                       steps=TRAIN_STEPS):
    """Phase 20 (b). ``phase9``: phase 9's results; ``phase17_ms``: phase
    17 (a)'s step ms. Returns the launches (forward, dq, dkv)."""
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.observability import goodput
    from ray_tpu_torch.train import TorchTrainer

    n = width["n_layers"]
    per_step = (2 * n, n, n)
    first = np.random.default_rng(SEED + 4).integers(
        0, width["vocab_size"], size=batch)
    rest = np.random.default_rng(SEED + 20).integers(
        0, width["vocab_size"], size=(steps * batch[0], batch[1]))
    tokens = np.concatenate([first, rest]).astype(np.int32)
    blocks = np.split(tokens, steps + 1)
    ds = rt.data.from_numpy(blocks)
    assert ds.num_blocks() == steps + 1
    # one batch's pin and copy, on the host clock
    host = torch.from_numpy(blocks[0])
    copy_ms = []
    for _ in range(COPY_RUNS):
        t0 = time.perf_counter()
        host.pin_memory().to(device, non_blocking=True)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    config = dict(width=width, device=str(device), seed=SEED,
                  batch=batch[0], blocks=blocks)
    trainer = TorchTrainer(
        data_trainer_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=1,
                                     use_gpu=device.type == "cuda"),
        datasets={"train": ds}, results_timeout_s=TRAINER_TIMEOUT_S)
    goodput.reset()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    t0 = time.perf_counter()
    result = trainer.fit()
    fit_s = time.perf_counter() - t0
    launches = launch_counts(fa)
    assert result.error is None, result.error
    ledger = goodput.snapshot()["jobs"]["default"]
    hist = result.metrics_history
    assert [m["step"] for m in hist] == list(range(steps + 1)), hist
    losses = [m["loss"] for m in hist]
    norms = [m["grad_norm"] for m in hist]
    assert all(np.isfinite(losses + norms)), (losses, norms)
    np.testing.assert_allclose(losses[0], phase9["losses"][0],
                               rtol=TRAIN_RTOL)
    assert all(m["launches"] == per_step for m in hist), \
        [m["launches"] for m in hist]
    assert launches == tuple((steps + 1) * c for c in per_step), launches
    assert all(m["equal"] and m["shape"] == batch for m in hist), hist
    if device.type == "cuda":
        assert all(m["dtensor"] and m["device"] == "cuda" for m in hist), \
            hist
    step_ms = statistics.median(m["step_ms"] for m in hist[1:])
    share = ledger["cats"].get("data_wait", 0.0) / ledger["wall_s"]
    log(f"[data] (b) TorchTrainer(datasets={{'train': ds}}), 1 use_gpu "
        f"worker, {steps + 1} int32 blocks of {batch[0]} x {batch[1]} "
        f"through iter_device_batches(sharding=(mesh, batch_sharding(mesh))"
        f", prefetch_batches=2): every batch a CUDA DTensor equal to its "
        f"block; losses {losses} (step 0 vs phase 9's {phase9['losses'][0]}"
        f" at rtol {TRAIN_RTOL}), grad norms {norms}; launches a step "
        f"{per_step} (forward, dq, dkv), {launches} in {steps + 1} steps; "
        f"fit() {fit_s:.1f} s")
    log(f"[times] {card}: TorchTrainer bf16 step fed by the dataset "
        f"{step_ms:.3f} ms (median of {steps}; steps in ms: "
        + ", ".join(f"{m['step_ms']:.1f}" for m in hist)
        + f"), phase 9's direct step {phase9['step_ms']:.3f} ms, phase 17 "
        f"(a)'s {phase17_ms:.3f} ms in this run; goodput ledger data_wait "
        f"{ledger['cats'].get('data_wait', 0.0):.4f} s of "
        f"{ledger['wall_s']:.3f} s wall ({100 * share:.3f}%); one "
        f"{batch[0]} x {batch[1]} int32 batch's pin and copy "
        f"{statistics.median(copy_ms):.3f} ms on the host clock (median of "
        f"{COPY_RUNS})")
    return launches


def matmul_threads(n, device):
    """A bf16 and an f32 matmul on each of ``n`` new threads running at
    once. Returns the device bytes this took outside the caching allocator:
    PyTorch gives each thread that runs a matmul its own cuBLAS handles and
    keeps them, pooled for reuse by later threads, for the life of the
    process."""
    free_device_caches()
    before = torch.cuda.mem_get_info(device)[0]
    start = threading.Barrier(n)

    def work():
        start.wait(timeout=60)
        for dt in (torch.bfloat16, torch.float32):
            a = torch.ones(64, 64, device=device, dtype=dt)
            (a @ a).sum().item()

    threads = [threading.Thread(target=work) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    free_device_caches()
    return before - torch.cuda.mem_get_info(device)[0]


def data_plane_phase(fa, device, card, direct, phase9, phase17_ms):
    """Phase 20: the data plane feeding the flagship through
    ``BatchPredictor`` and ``TorchTrainer(datasets=)``, then the card's
    memory back. Returns the launches (forward, dq, dkv) of (a) and (b)."""
    import ray_tpu_torch as rt
    import ray_tpu_torch.data  # noqa: F401
    # (a)'s map tasks and (b)'s worker run matmuls on up to DATA_BLOCKS + 2
    # threads at once, more than earlier phases: their cuBLAS handles are
    # made here, so that (c) sees what the phase itself leaves behind.
    pooled = matmul_threads(DATA_BLOCKS + 4, device)
    log(f"[data] {DATA_BLOCKS + 4} new threads' first matmuls took {pooled} "
        f"bytes of device memory outside the caching allocator (cuBLAS "
        f"handles, pooled for the process's life); 4 more took "
        f"{matmul_threads(4, device)}")
    free_device_caches()
    free_before = torch.cuda.mem_get_info(device)[0]
    config = {k: str(REPO / v) for k, v in RUNTIME_CONFIG.items()}
    rt.init(num_cpus=8, _system_config=config)
    try:
        forward = batch_predictor_phase(rt, fa, device, card, direct)
        free_device_caches()
        trained = data_trainer_phase(rt, fa, device, card, phase9,
                                     phase17_ms)
    finally:
        rt.shutdown()
    free_after = None
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        free_device_caches()
        free_after = torch.cuda.mem_get_info(device)[0]
        if free_before - free_after <= PROCESS_MEMORY_SLACK:
            break
        time.sleep(0.2)
    assert free_before - free_after <= PROCESS_MEMORY_SLACK, (
        free_before, free_after)
    log(f"[data] (c) shutdown(): the card's free memory {free_before} bytes "
        f"before (a), {free_after} after")
    return (trained[0] + forward, trained[1], trained[2])


# -- phase 21: the RL path (rl/ PPO, tune/) ----------------------------------


def ppo_gate_config(device, **rollouts):
    """``tests/test_rl.py:197-218``'s PPO on CartPole (8 envs x 100 steps,
    train batch 800, minibatch 256, 8 SGD passes, lr 3e-4, entropy 0.01, no
    KL, clip 0.2, seed 0), its learner on ``device``."""
    from ray_tpu_torch.rl import PPO
    kw = dict(num_rollout_workers=0, num_envs_per_worker=8,
              rollout_fragment_length=100)
    kw.update(rollouts)
    return (PPO.get_default_config()
            .environment("CartPole-v1")
            .rollouts(**kw)
            .training(train_batch_size=800, sgd_minibatch_size=256,
                      num_sgd_iter=8, lr=3e-4, entropy_coeff=0.01,
                      kl_coeff=0.0, clip_param=0.2)
            .resources(device=str(device))
            .debugging(seed=SEED))


def rl_learner_parity(device):
    """Phase 21 (1): one ``sgd`` call (8 epochs x 3 minibatches of 256) of
    the learner on the card against the learner on the CPU: the same
    weights, the same sample batch from a CPU rollout worker (standardized
    advantages, cut to 768 rows) and the same permutations. Returns the
    largest differences (parameters, metrics)."""
    from ray_tpu_torch.rl import RolloutWorker
    from ray_tpu_torch.rl import models as rl_models
    from ray_tpu_torch.rl.postprocessing import standardize
    from ray_tpu_torch.rl.ppo import PPOLearner
    from ray_tpu_torch.rl.sample_batch import SampleBatch, batch_to_device

    cfg = ppo_gate_config(device)
    worker = RolloutWorker("CartPole-v1", num_envs=8,
                           rollout_fragment_length=100, seed=SEED,
                           device="cpu")
    batch = worker.sample()
    batch[SampleBatch.ADVANTAGES] = standardize(
        batch[SampleBatch.ADVANTAGES])
    n = len(batch) // cfg.sgd_minibatch_size * cfg.sgd_minibatch_size
    batch = batch.slice(0, n)
    gen = torch.Generator().manual_seed(SEED + 21)
    perms = [torch.randperm(n, generator=gen)
             for _ in range(cfg.num_sgd_iter)]
    weights = worker.get_weights()
    out = {}
    for dev in (torch.device("cpu"), device):
        learner = PPOLearner(weights, cfg, False, device=dev)
        metrics = learner.sgd(batch_to_device(batch, dev), 0.2,
                              [p.to(dev) for p in perms])
        out[dev.type] = (learner.get_weights(), metrics)
    (pc, mc), (pg, mg) = out["cpu"], out[device.type]
    for a, b in zip(rl_models.tree_leaves(pg), rl_models.tree_leaves(pc)):
        np.testing.assert_allclose(a, b, rtol=RL_RTOL, atol=RL_ATOL)
    for k in mc:
        np.testing.assert_allclose(mg[k], mc[k], rtol=RL_RTOL, atol=RL_ATOL)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        rl_models.tree_leaves(pc), rl_models.tree_leaves(weights)))
    return (max(float(np.abs(a - b).max()) for a, b in zip(
                rl_models.tree_leaves(pg), rl_models.tree_leaves(pc))),
            max(abs(mg[k] - mc[k]) for k in mc), moved, n)


def rl_learn(device, iters=RL_ITERS):
    """Phase 21 (2): ``build().train()`` of the gate's PPO, ``iters``
    iterations, the learner on ``device``. Each iteration's sampling and
    learning are timed on the host clock (the learner reads its metrics
    back, so its device work ends inside). Returns the first and final
    ``episode_reward_mean`` and the times."""
    algo = ppo_gate_config(device).build()
    assert algo.learner.device.type == device.type, algo.learner.device
    sample_ms, learn_ms = [], []

    def timed(fn, into):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    algo.workers.local_worker.sample = timed(algo.workers.local_worker.sample,
                                             sample_ms)
    algo.learner.train = timed(algo.learner.train, learn_ms)
    first = result = None
    iter_s, steps = [], []
    try:
        for _ in range(iters):
            t0 = time.perf_counter()
            result = algo.train()
            iter_s.append(time.perf_counter() - t0)
            steps.append(result["timesteps_this_iter"])
            if first is None and "episode_reward_mean" in result:
                first = result["episode_reward_mean"]
    finally:
        algo.stop()
        shutil.rmtree(algo.logdir, ignore_errors=True)
    # the first iteration carries the learner's warm-up; the rate leaves it
    return {"first": first, "final": result["episode_reward_mean"],
            "steps_per_s": sum(steps[1:]) / sum(iter_s[1:]),
            "sample_ms": statistics.median(sample_ms[1:]),
            "learn_ms": statistics.median(learn_ms[1:]),
            "first_learn_ms": learn_ms[0],
            "timesteps": sum(steps)}


def _tunable_ppo(device):
    """The PPO subclass phase 21 (3) hands ``tune.run``: the gate's config
    with ``lr`` from the trial's config, reporting where its learner's
    tensors live and what the trial actor was granted."""
    from ray_tpu_torch.rl import PPO

    class TunablePPO(PPO):
        def __init__(self, config=None, logdir=None):
            cfg = ppo_gate_config(device).training(
                lr=(config or {}).get("lr", 3e-4))
            super().__init__(config=cfg, logdir=logdir)

        def step(self):
            import ray_tpu_torch
            from ray_tpu_torch.rl import models as rl_models
            result = super().step()
            result["learner_devices"] = sorted({
                str(t.device)
                for t in rl_models.tree_leaves(self.learner.params)})
            result["granted"] = [str(d) for d in ray_tpu_torch
                                 .get_runtime_context().get_gpu_devices()]
            return result

    return TunablePPO


def rl_phase(fa, device, card):
    """Phase 21: the RL path on the card. Returns nothing: no flash kernel
    runs, and the launch counters must not move."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune

    # the trial actor's thread runs matmuls on the card: take its cuBLAS
    # handles from the pool first, so that (5) sees what the phase leaves
    matmul_threads(4, device)
    free_device_caches()
    free_before = torch.cuda.mem_get_info(device)[0]
    counts = launch_counts(fa)
    t_phase = time.perf_counter()

    # (1) the learner on the card against the learner on the CPU
    t0 = time.perf_counter()
    p_err, m_err, moved, n = rl_learner_parity(device)
    log(f"[rl] (1) PPOLearner.sgd on {device} against the CPU, the same "
        f"weights, {n} rows and 8 permutations (24 minibatch steps, TF32 "
        f"off): largest parameter difference {p_err:.3e} (the parameters "
        f"moved up to {moved:.3e}), largest metric difference {m_err:.3e}, "
        f"at rtol {RL_RTOL}, atol {RL_ATOL}; {time.perf_counter() - t0:.1f} "
        f"s")

    # (2) PPO on CartPole at the gate's config, learner on the card, then on
    # the CPU for comparison
    t0 = time.perf_counter()
    g, c = rl_learn(device), rl_learn(torch.device("cpu"))
    for r in (g, c):
        assert r["final"] > max(80.0, 2.0 * r["first"]), r
    log(f"[rl] (2) PPO on CartPole-v1, {RL_ITERS} iterations of 800 env "
        f"steps (8 envs x 100; 768 learned a pass, 8 passes of 3 "
        f"minibatches): learner on the card episode_reward_mean "
        f"{g['first']:.2f} -> {g['final']:.2f}, on the CPU {c['first']:.2f}"
        f" -> {c['final']:.2f}; the gate final > max(80, 2 x first) holds "
        f"for both; {time.perf_counter() - t0:.1f} s")
    log(f"[times] {card}: PPO CartPole env-steps/s, learner on the card "
        f"{g['steps_per_s']:.1f} (sample {g['sample_ms']:.2f} ms, learn "
        f"{g['learn_ms']:.2f} ms an iteration, medians of {RL_ITERS - 1}; "
        f"the first learn {g['first_learn_ms']:.1f} ms), learner on the CPU"
        f" {c['steps_per_s']:.1f} (sample {c['sample_ms']:.2f} ms, learn "
        f"{c['learn_ms']:.2f} ms); rates over iterations 2-{RL_ITERS}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rl_")
    rt.init(num_cpus=8)
    try:
        # (3) tune.run of a PPO subclass: one trial actor holding the card
        assert rt.cluster_resources().get("GPU") == 1.0
        t0 = time.perf_counter()
        analysis = tune.run(_tunable_ppo(device), config={"lr": 3e-4},
                            resources_per_trial={"cpu": 1, "gpu": 1},
                            stop={"training_iteration": RL_TUNE_ITERS},
                            metric="episode_reward_mean", mode="max",
                            local_dir=tmp, verbose=0)
        trial = analysis.trials[0]
        assert trial.status == "TERMINATED", (trial.status, trial.error)
        assert len(trial.results) == RL_TUNE_ITERS, trial.results
        on = "cuda:0" if device.type == "cuda" else str(device)
        assert all(r["learner_devices"] == [on]
                   and r["granted"] == ["cuda:0"] for r in trial.results), \
            trial.results
        assert rt.available_resources().get("GPU") == 1.0
        log(f"[rl] (3) tune.run(TunablePPO, resources_per_trial={{'cpu': 1, "
            f"'gpu': 1}}): {RL_TUNE_ITERS} iterations in the trial actor, "
            f"granted {trial.results[-1]['granted']}, learner tensors on "
            f"{trial.results[-1]['learner_devices']}; the GPU free again "
            f"after the trial; {time.perf_counter() - t0:.1f} s")

        # (4) two remote rollout workers (CPU actors) under init()
        t0 = time.perf_counter()
        algo = ppo_gate_config(device, num_rollout_workers=2).build()
        try:
            results = [algo.train() for _ in range(RL_TUNE_ITERS)]
            where = rt.get([w.apply.remote(lambda w: str(w.policy.device))
                            for w in algo.workers.remote_workers],
                           timeout=60)
        finally:
            algo.stop()
            shutil.rmtree(algo.logdir, ignore_errors=True)
        assert where == ["cpu", "cpu"], where
        assert all(r["timesteps_this_iter"] >= 768 for r in results), results
        log(f"[rl] (4) PPO with 2 remote rollout workers (policies on "
            f"{where}), learner on the card: {RL_TUNE_ITERS} iterations, "
            f"timesteps {[r['timesteps_this_iter'] for r in results]}, "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)

    # (5) the card's memory is back, and no flash kernel ran
    assert launch_counts(fa) == counts, (launch_counts(fa), counts)
    free_after = None
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        free_device_caches()
        free_after = torch.cuda.mem_get_info(device)[0]
        if free_before - free_after <= PROCESS_MEMORY_SLACK:
            break
        time.sleep(0.2)
    assert free_before - free_after <= PROCESS_MEMORY_SLACK, (
        free_before, free_after)
    log(f"[rl] (5) the card's free memory {free_before} bytes before (1), "
        f"{free_after} after; the flash launch counters did not move; phase"
        f" 21 in {time.perf_counter() - t_phase:.1f} s")


# -- phase 22: the single-learner algorithms of rl/ ---------------------------


def memory_cue_ppo(device, model):
    """``tests/test_rl_extended.py:177-212``'s PPO on MemoryCue-v0 (16 envs
    x 20 steps, train batch 640, minibatch 160 = 8 sequences, 10 SGD
    passes, lr 1e-3, clip 10, entropy 0.01, seed 0) with ``model``, its
    learner on ``device``."""
    from ray_tpu_torch.rl import PPO
    return (PPO.get_default_config()
            .environment("MemoryCue-v0")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=16,
                      rollout_fragment_length=20)
            .training(train_batch_size=640, sgd_minibatch_size=160,
                      num_sgd_iter=10, lr=1e-3, grad_clip=10.0,
                      entropy_coeff=0.01, model=model)
            .resources(device=str(device))
            .debugging(seed=SEED))


def lstm_impala(device):
    """``tests/test_rl_extended.py:231-249``'s IMPALA with an LSTM of 64 on
    CartPole (1 remote worker, 8 envs x 50 steps, lr 1e-3, entropy 0.01)."""
    from ray_tpu_torch.rl import Impala
    return (Impala.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=1, num_envs_per_worker=8,
                      rollout_fragment_length=50)
            .training(lr=1e-3, entropy_coeff=0.01,
                      model={"use_lstm": True, "lstm_cell_size": 64})
            .resources(device=str(device))
            .debugging(seed=SEED))


def appo_gate(device):
    """``tests/test_rl.py:650-670``'s APPO on CartPole (2 remote workers, 4
    envs x 50 steps, APPO's defaults: clip 0.3, RMSprop lr 3e-3)."""
    from ray_tpu_torch.rl import APPO
    return (APPO.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=4,
                      rollout_fragment_length=50)
            .resources(device=str(device))
            .debugging(seed=SEED))


def dqn_gate(device):
    """``tests/test_rl.py:276-293``'s DQN on CartPole (4 envs x 16 steps,
    batch 64, lr 1e-3, double Q, target sync every 100 updates, 8 updates
    an iteration once 1000 steps are stored)."""
    from ray_tpu_torch.rl import DQN
    return (DQN.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=4,
                      rollout_fragment_length=16)
            .training(train_batch_size=64, gamma=0.99, lr=1e-3,
                      replay_buffer_capacity=20_000,
                      num_steps_sampled_before_learning_starts=1000,
                      epsilon_timesteps=8000, n_updates_per_iter=8,
                      target_network_update_freq=100, grad_clip=10.0)
            .resources(device=str(device))
            .debugging(seed=SEED))


def pendulum_gate(name, device):
    """``tests/test_rl.py``'s SAC (:374-399) and TD3 (:603-625) and
    ``tests/test_rl_extended.py:28-51``'s DDPG gate config on Pendulum:
    fcnet (256, 256), batch 128, 8 updates an iteration once 256 steps are
    stored, seed 0."""
    import ray_tpu_torch.rl as rl
    return (getattr(rl, name).get_default_config()
            .environment("Pendulum-v1")
            .training(train_batch_size=128, n_updates_per_iter=8,
                      num_steps_sampled_before_learning_starts=256)
            .resources(device=str(device))
            .debugging(seed=SEED))


def _run_on(devices, build, update):
    """``update(learner, dev)`` on ``learner = build(dev)`` for each
    device: -> ({device type: (host tree of what moved, metrics)}, the
    last device's learner)."""
    out = {}
    for dev in devices:
        learner = build(dev)
        out[dev.type] = update(learner, dev)
    return out, learner


def _seeded_perms(n, count, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randperm(n, generator=gen) for _ in range(count)]


def _seeded_normals(shape, count, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen) for _ in range(count)]


def parity_recurrent_ppo(devices, model):
    """One ``RecurrentPPOLearner.sgd`` (the gate's schedule: 10 passes of 4
    minibatches of 8 sequences) on a CPU worker's MemoryCue batch,
    advantages standardized, the same permutations on every device. ->
    (results, start, one more schedule on the last device, its optimizer
    steps)."""
    from ray_tpu_torch.rl import RolloutWorker
    from ray_tpu_torch.rl.postprocessing import standardize
    from ray_tpu_torch.rl.recurrent import (RecurrentPolicy,
                                            RecurrentPPOLearner,
                                            sequence_arrays)
    from ray_tpu_torch.rl.sample_batch import SampleBatch, batch_to_device
    cfg = memory_cue_ppo("cpu", model)
    T = cfg.rollout_fragment_length
    worker = RolloutWorker("MemoryCue-v0", num_envs=16,
                           rollout_fragment_length=T, policy_config=model,
                           seed=SEED, policy_cls=RecurrentPolicy,
                           device="cpu")
    batch = worker.sample()
    batch[SampleBatch.ADVANTAGES] = standardize(batch[SampleBatch.ADVANTAGES])
    mb = cfg.sgd_minibatch_size // T
    arrays = sequence_arrays(batch, T, mb)
    n_seq = len(arrays[SampleBatch.OBS])
    perms = _seeded_perms(n_seq, cfg.num_sgd_iter, SEED + 22)
    weights = worker.get_weights()

    def schedule(learner, dev):
        return learner.sgd(batch_to_device(arrays, dev), 0.2,
                           [p.to(dev) for p in perms])

    def update(learner, dev):
        metrics = schedule(learner, dev)
        return learner.get_weights(), metrics

    out, learner = _run_on(devices, lambda dev: RecurrentPPOLearner(
        weights, cfg, False, T, device=dev), update)
    return (out, weights, lambda: schedule(learner, learner.device),
            cfg.num_sgd_iter * (n_seq // mb))


def parity_impala(devices, cfg):
    """One ``ImpalaLearner`` update on a CPU worker's time-major CartPole
    batch (8 envs x 50 steps)."""
    from ray_tpu_torch.rl import Policy, RolloutWorker
    from ray_tpu_torch.rl.impala import ImpalaLearner, to_time_major
    from ray_tpu_torch.rl.recurrent import RecurrentPolicy, uses_memory_model
    T = cfg.rollout_fragment_length
    worker = RolloutWorker(
        "CartPole-v1", num_envs=8, rollout_fragment_length=T,
        policy_config=dict(cfg.model), seed=SEED, compute_advantages=False,
        policy_cls=(RecurrentPolicy if uses_memory_model(cfg.model)
                    else Policy), device="cpu")
    worker.sample()     # a second fragment, behind the policy's first
    tm = to_time_major(worker.sample(), T)
    weights = worker.get_weights()

    def update(learner, dev):
        metrics = learner.train(tm)
        return learner.get_weights(), metrics

    out, learner = _run_on(devices, lambda dev: ImpalaLearner(
        weights, cfg, False, clip_param=cfg.clip_param, device=dev), update)
    return out, weights, lambda: learner.train(tm), 1


def replay_sample(policy_cls, env, cfg, n_steps):
    """``cfg.train_batch_size`` transitions replayed from ``n_steps``
    steps of a CPU worker, as the algorithm's replay buffer hands them to
    its learner."""
    from ray_tpu_torch.rl import ReplayBuffer, RolloutWorker
    from ray_tpu_torch.rl.postprocessing import add_next_obs
    worker = RolloutWorker(env, num_envs=1, rollout_fragment_length=n_steps,
                           policy_config=dict(cfg.model), seed=SEED,
                           compute_advantages=False, policy_cls=policy_cls,
                           device="cpu")
    replay = ReplayBuffer(1000, seed=SEED)
    replay.add(add_next_obs(worker.sample()))
    return worker, replay.sample(cfg.train_batch_size)


def parity_dqn(devices):
    """One double-Q TD update of the DQN gate's learner on 64 replayed
    CartPole transitions: the loss and TD errors read back (one
    device->host copy), and the parameters."""
    from ray_tpu_torch.rl.dqn import DQNLearner, EpsilonGreedyPolicy
    cfg = dqn_gate("cpu")
    assert cfg.double_q
    worker, batch = replay_sample(EpsilonGreedyPolicy, "CartPole-v1", cfg,
                                  200)
    weights = worker.get_weights()

    def update(learner, dev):
        loss, td = learner.train(batch)
        assert learner.host_reads == 1
        return (learner.get_weights(),
                {"loss": loss, **{f"td[{i}]": float(x)
                                  for i, x in enumerate(td)}})

    out, learner = _run_on(
        devices, lambda dev: DQNLearner(weights, cfg, device=dev), update)
    return out, weights, lambda: learner.train(batch), 1


def parity_sac(devices):
    """One SAC update at fcnet (256, 256) on 128 replayed Pendulum
    transitions, the critics carried from the CPU learner's init and the
    two normals fed."""
    from ray_tpu_torch.rl.sac import AUX_KEYS, _USED, SACLearner
    from ray_tpu_torch.rl.sac import SquashedGaussianPolicy
    from ray_tpu_torch.rl.sample_batch import batch_to_device
    cfg = pendulum_gate("SAC", "cpu")
    worker, batch = replay_sample(SquashedGaussianPolicy, "Pendulum-v1",
                                  cfg, 200)
    pol = worker.policy
    start = SACLearner(worker.get_weights(), 3, 1, pol._scale, pol._center,
                       cfg, device="cpu").state()
    noise = _seeded_normals((cfg.train_batch_size, 1), 2, SEED + 22)
    used = {k: v for k, v in batch.items() if k in _USED}

    def build(dev):
        learner = SACLearner(worker.get_weights(), 3, 1, pol._scale,
                             pol._center, cfg, device=dev)
        learner.set_state(start)
        return learner

    def update(learner, dev):
        aux = learner.update(batch_to_device(used, dev),
                             *(n.to(dev) for n in noise))
        state = learner.state()
        return (state[0], state[1]), dict(zip(AUX_KEYS, aux.tolist()))

    out, learner = _run_on(devices, build, update)
    return out, (start[0], start[1]), lambda: learner.train(batch), 1


def parity_td3(devices):
    """A TD3 critic-only step, then an actor step (targets move), at fcnet
    (256, 256) on two replayed Pendulum batches, the critics carried from
    the CPU learner's init and the smoothing noise fed."""
    from ray_tpu_torch.rl.sample_batch import batch_to_device
    from ray_tpu_torch.rl.td3 import (AUX_KEYS, _USED, DeterministicPolicy,
                                      TD3Learner)
    cfg = pendulum_gate("TD3", "cpu")
    worker, batch = replay_sample(DeterministicPolicy, "Pendulum-v1", cfg,
                                  400)
    pol = worker.policy
    start = TD3Learner(worker.get_weights(), 3, 1, pol._scale, pol._center,
                       cfg, device="cpu").state()
    noise = _seeded_normals((cfg.train_batch_size, 1), 2, SEED + 22)
    halves = [{k: v[i::2] for k, v in batch.items() if k in _USED}
              for i in (0, 1)]

    def build(dev):
        learner = TD3Learner(worker.get_weights(), 3, 1, pol._scale,
                             pol._center, cfg, device=dev)
        learner.set_state(start)
        return learner

    def update(learner, dev):
        metrics = {}
        for step, (half, n) in enumerate(zip(halves, noise)):
            aux = learner.update(batch_to_device(half, dev), n[::2].to(dev),
                                 do_actor=step == 1)
            metrics.update({f"{k}[{step}]": v
                            for k, v in zip(AUX_KEYS, aux.tolist())})
        return learner.state()[:3], metrics

    out, learner = _run_on(devices, build, update)
    return out, start[:3], lambda: learner.train(batch), 1


def assert_parity(name, out, start, device):
    """The card's tree and metrics against the CPU's at ``RL_RTOL`` /
    ``RL_ATOL``: -> (largest parameter difference, largest metric
    difference, largest move of a parameter from ``start``, the largest
    difference over the largest move)."""
    from ray_tpu_torch.rl import models as rl_models
    (pc, mc), (pg, mg) = out["cpu"], out[device.type]
    cpu_leaves, card_leaves = (rl_models.tree_leaves(t) for t in (pc, pg))
    for a, b in zip(card_leaves, cpu_leaves):
        np.testing.assert_allclose(a, b, rtol=RL_RTOL, atol=RL_ATOL,
                                   err_msg=name)
    assert set(mg) == set(mc), (name, sorted(mg), sorted(mc))
    for k in mc:
        np.testing.assert_allclose(mg[k], mc[k], rtol=RL_RTOL, atol=RL_ATOL,
                                   err_msg=f"{name}: {k}")
    p_err = max(float(np.abs(a - b).max())
                for a, b in zip(card_leaves, cpu_leaves))
    moved = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
        cpu_leaves, rl_models.tree_leaves(start)))
    return (p_err, max(abs(mg[k] - mc[k]) for k in mc), moved,
            p_err / moved)


def rl_slice_cases():
    """Phase 22 (1)'s cases: (name, ``case(devices)``), each one update of
    a learner at its full width on each of ``devices``."""
    from ray_tpu_torch.rl.impala import APPOConfig, ImpalaConfig
    lstm = {"use_lstm": True, "lstm_cell_size": 64}
    attention = {"use_attention": True, "attention_dim": 64,
                 "attention_window": 8}
    return [
        ("RecurrentPPOLearner, LSTM 64",
         lambda devices: parity_recurrent_ppo(devices, lstm)),
        ("RecurrentPPOLearner, attention 64 / window 8",
         lambda devices: parity_recurrent_ppo(devices, attention)),
        ("ImpalaLearner, RMSprop", lambda devices: parity_impala(
            devices, ImpalaConfig().rollouts(rollout_fragment_length=50))),
        ("ImpalaLearner, APPO's clip", lambda devices: parity_impala(
            devices, APPOConfig().rollouts(rollout_fragment_length=50))),
        ("ImpalaLearner, LSTM 64 (Adam)",
         lambda devices: parity_impala(devices, lstm_impala("cpu"))),
        ("DQNLearner, double Q", parity_dqn),
        ("SACLearner, (256, 256)", parity_sac),
        ("TD3Learner, (256, 256), critic-only then actor step", parity_td3),
    ]


def rl_slice_parity(device, cases=None):
    """Phase 22 (1) (and 23 (1) with its ``cases``): each learner of the
    slice on the card against itself on the CPU, one update at its full
    width, then the card's learner alone for ``RL_TIMED_STEPS`` optimizer
    steps more, on the host clock (each update ends in its metrics'
    read-back). -> [(name, errors, seconds, ms an optimizer step, one more
    update on the card)]."""
    devices = (torch.device("cpu"), device)
    results = []
    for name, case in cases or rl_slice_cases():
        t0 = time.perf_counter()
        out, start, again, steps = case(devices)
        errors = assert_parity(name, out, start, device)
        seconds = time.perf_counter() - t0
        calls = max(1, RL_TIMED_STEPS // steps)
        again()
        t0 = time.perf_counter()
        for _ in range(calls):
            again()
        ms = 1e3 * (time.perf_counter() - t0) / (calls * steps)
        results.append((name, errors, seconds, ms, again))
    return results


def optimizer_steps(learner):
    """The Adam step count of a learner's (critic) optimizer, or None for
    RMSprop, which keeps none."""
    for name in ("opt_state", "copt_state"):
        opt = getattr(learner, name, None)
        if opt is not None and "count" in opt:
            return opt["count"]
    return None


def rl_gate(config, iters):
    """``config.build()`` and ``iters`` calls of ``train()``, each
    iteration timed on the host clock, its learner's time apart (the
    learner reads its metrics back, so its device work ends inside). ->
    rewards (the first, the mean of the first 5 reported, the worst, the
    final) and rates."""
    algo = config.build()
    learner = algo.learner
    assert learner.device.type == torch.device(config.device).type
    spent, calls = [0.0], [0]
    train = learner.train

    def timed_train(*args, **kwargs):
        t0 = time.perf_counter()
        out = train(*args, **kwargs)
        spent[0] += time.perf_counter() - t0
        calls[0] += 1
        return out

    learner.train = timed_train
    steps0 = optimizer_steps(learner)
    rewards, wall, learn = [], [], []
    try:
        for _ in range(iters):
            spent[0] = 0.0
            t0 = time.perf_counter()
            result = algo.train()
            wall.append(time.perf_counter() - t0)
            learn.append(spent[0])
            if "episode_reward_mean" in result:
                rewards.append(result["episode_reward_mean"])
        updates = (calls[0] if steps0 is None
                   else optimizer_steps(learner) - steps0)
    finally:
        algo.stop()
        shutil.rmtree(algo.logdir, ignore_errors=True)
    wall_s = sum(wall)
    return {"first": rewards[0], "early": float(np.mean(rewards[:5])),
            "worst": min([0.0] + rewards), "final": rewards[-1],
            "iters": iters, "timesteps": result["timesteps_total"],
            "wall_s": wall_s,
            "env_steps_per_s": result["timesteps_total"] / wall_s,
            "updates": updates, "updates_per_s": updates / wall_s,
            "ms_per_update": 1e3 * sum(learn) / max(1, updates),
            "learn_ms": 1e3 * sum(learn) / iters,
            "sample_ms": 1e3 * (wall_s - sum(learn)) / iters,
            "host_reads": getattr(learner, "host_reads", None)}


# Phase 22 (2): name -> (config of the gate's learner on a device, its
# iterations, the gate and its check), longest first.
RL_GATES = {
    "PPO, attention 32 / window 8, MemoryCue": (
        lambda d: memory_cue_ppo(d, {"use_attention": True,
                                     "attention_dim": 32,
                                     "attention_window": 8}), 30,
        "final > 0.8", lambda r: r["final"] > 0.8),
    "SAC, Pendulum": (
        lambda d: pendulum_gate("SAC", d), 900,
        "final > -800 and > early + 100",
        lambda r: r["final"] > -800 and r["final"] - r["early"] > 100),
    "TD3, Pendulum": (
        lambda d: pendulum_gate("TD3", d), 900,
        "final > -850 and > early + 150",
        lambda r: r["final"] > -850 and r["final"] - r["early"] > 150),
    "PPO, LSTM 32, MemoryCue": (
        lambda d: memory_cue_ppo(d, {"use_lstm": True,
                                     "lstm_cell_size": 32}), 30,
        "final > 0.8", lambda r: r["final"] > 0.8),
    "DDPG, Pendulum": (
        lambda d: pendulum_gate("DDPG", d), 600,
        "final > -1000 and > worst + 250",
        lambda r: r["final"] > -1000 and r["final"] > r["worst"] + 250),
    "IMPALA, LSTM 64, CartPole, 1 remote worker": (
        lstm_impala, 60, "final > max(45, first + 15)",
        lambda r: r["final"] > max(45.0, r["first"] + 15)),
    "APPO, CartPole, 2 remote workers": (
        appo_gate, 200, "final > first + 40 and > 80",
        lambda r: r["final"] > r["first"] + 40 and r["final"] > 80),
    "DQN, CartPole": (
        dqn_gate, 250, "final > 50", lambda r: r["final"] > 50),
}


def run_gate(name, device):
    """Phase 22 (2), one gate in a process of its own: the learner on
    ``device``, rollouts on one intra-op CPU thread, remote rollout
    workers as CPU actors of an ``init()`` of this process."""
    import ray_tpu_torch as rt
    torch.set_num_threads(1)
    build, iters, _, passed = RL_GATES[name]
    config = build(torch.device(device))
    remote = config.num_rollout_workers > 0
    if remote:
        rt.init(num_cpus=8)
    try:
        r = rl_gate(config, iters)
    finally:
        if remote:
            rt.shutdown()
    r["passed"] = passed(r)
    return r


def run_gates(device, processes=RL_GATE_PROCESSES):
    """Phases 22 (2) and 23 (2): every gate of ``RL_GATES``, then every
    gate of ``RL_MULTI_GATES``, ``processes`` at a time in one pool, each
    in a spawned process. Phase 23's gates are short: they run in the slots
    that phase 22's longest gate leaves free. -> ({name: result} of phase
    22, {name: result} of phase 23)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes) as pool:
        slice_gates = {name: pool.apply_async(run_gate, (name, str(device)))
                       for name in RL_GATES}
        multi_gates = {name: pool.apply_async(run_multi_gate,
                                              (name, str(device)))
                       for name in RL_MULTI_GATES}
        pool.close()
        pool.join()
        return ({name: r.get() for name, r in slice_gates.items()},
                {name: r.get() for name, r in multi_gates.items()})


def process_warmup(device):
    """The process's one-time device costs that phase 22 would otherwise
    make after its memory baseline: cuBLAS handles for new threads (the
    autograd engine's device thread among them), the profiler's first
    session, and the code of every kernel the learners launch, which CUDA
    loads at a kernel's first launch and keeps for the process's life (a
    second pass of (1) takes no more). Returns the device bytes they
    took."""
    from torch.profiler import ProfilerActivity, profile
    free_device_caches()
    before = torch.cuda.mem_get_info(device)[0]
    matmul_threads(4, device)
    x = torch.ones(64, 64, device=device, requires_grad=True)
    (x @ x).sum().backward()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (x @ x).sum().item()
    del x
    for _, case in rl_slice_cases():
        case((device,))
    free_device_caches()
    return before - torch.cuda.mem_get_info(device)[0]


def rl_slice_phase(fa, device, card):
    """Phase 22: the memory models, IMPALA/APPO, DQN, SAC, TD3 and DDPG
    with their learners on the card; phase 23's gates run in (2)'s pool.
    Returns those gates' results: no flash kernel runs, and the launch
    counters must not move."""
    warm = process_warmup(device)
    free_device_caches()
    free_before = torch.cuda.mem_get_info(device)[0]
    counts = launch_counts(fa)
    t_phase = time.perf_counter()

    # (1) each learner on the card against the same learner on the CPU,
    # then the card's learner alone
    parity = rl_slice_parity(device)
    for name, (p_err, m_err, moved, share), seconds, ms, _ in parity:
        log(f"[rl-slice] (1) {name}: card against CPU (TF32 off), largest "
            f"parameter difference {p_err:.3e} (the parameters moved up to "
            f"{moved:.3e}: {share:.2e} of it), largest metric difference "
            f"{m_err:.3e}, at rtol {RL_RTOL}, atol {RL_ATOL}; {seconds:.1f} "
            f"s")
        log(f"[times] {card}: {name}: {ms:.3f} ms an optimizer step on the "
            f"card alone (host clock, {RL_TIMED_STEPS} steps or more)")

    # (3) where a SAC update's time goes
    sac = next(again for name, *_, again in parity if name.startswith("SAC"))
    n = RL_PROFILE_UPDATES
    prof = profile_steps(sac, steps=n)
    log(f"[profile] {card}: {n} SAC updates (batch 128, fcnet (256, 256)) in"
        f" {prof['wall_s']:.3f} s under the profiler, "
        f"{1e3 * prof['wall_s'] / n:.3f} ms each; device busy "
        f"{100 * prof['busy_share']:.1f}% of the window; "
        f"{prof['kernels'] / n:.1f} kernel launches and "
        f"{prof['copies'] / n:.1f} copies an update; operators by the device"
        f" time of their own kernels: " + "; ".join(
            f"{k} {100 * s:.1f}% ({c})" for k, s, c in prof["top"]))
    del parity, sac

    # (2) the learning gates, learners on the card (rollouts on the CPU;
    # remote workers are CPU actors), RL_GATE_PROCESSES at a time, phase
    # 23's after them in the same pool
    t0 = time.perf_counter()
    gates, multi_gates = run_gates(device)
    gates_s = time.perf_counter() - t0
    for name, r in gates.items():
        gate = RL_GATES[name][2]
        assert r["passed"], (name, gate, r)
        reads = ("" if r["host_reads"] is None else
                 f", {r['host_reads'] / r['updates']:.2f} device->host reads"
                 f" an update")
        log(f"[rl-slice] (2) {name}: {r['iters']} iterations, learner on the"
            f" card, episode_reward_mean first {r['first']:.2f}, early "
            f"{r['early']:.2f}, worst {r['worst']:.2f}, final "
            f"{r['final']:.2f}: the gate {gate} holds; {r['wall_s']:.1f} s")
        log(f"[times] {card}: {name}, {RL_GATE_PROCESSES} gates at a time: "
            f"{r['env_steps_per_s']:.1f} env-steps/s, "
            f"{r['updates_per_s']:.1f} learner updates/s ({r['updates']} "
            f"updates, {r['ms_per_update']:.3f} ms each on the host clock), "
            f"sample {r['sample_ms']:.2f} ms and learn {r['learn_ms']:.2f} ms"
            f" an iteration (means of {r['iters']}){reads}")
    log(f"[rl-slice] (2) {len(gates)} gates and phase 23's "
        f"{len(multi_gates)} in {gates_s:.1f} s, {RL_GATE_PROCESSES} "
        f"processes at a time")

    # (4) the card's memory is back, and no flash kernel ran
    assert launch_counts(fa) == counts, (launch_counts(fa), counts)
    free_after = None
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        free_device_caches()
        free_after = torch.cuda.mem_get_info(device)[0]
        if free_before - free_after <= PROCESS_MEMORY_SLACK:
            break
        time.sleep(0.2)
    assert free_before - free_after <= PROCESS_MEMORY_SLACK, (
        free_before, free_after)
    log(f"[rl-slice] (4) the card's free memory {free_before} bytes before "
        f"(1), {free_after} after (the process's one-time costs, {warm} "
        f"bytes: cuBLAS handles, the profiler, the learners' kernels' code, "
        f"paid before); the flash launch counters did not move; "
        f"phase 22 in {time.perf_counter() - t_phase:.1f} s")
    return multi_gates


# -- phase 23: the multi-learner slice of rl/ --------------------------------


class CartPoleExpert:
    """``tests/test_rl.py``'s hand-coded balance controller (``flip``: its
    anti-expert, ``tests/test_rl_extended.py``'s)."""
    continuous = False

    def __init__(self, flip=False):
        self.flip = flip

    def compute_actions(self, obs, explore=True):
        obs = np.atleast_2d(obs)
        a = (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int64)
        if self.flip:
            a = 1 - a
        z = np.zeros(len(a), np.float32)
        return a, z, z


def expert_dataset(n_steps=4000):
    """The BC and CQL gates' dataset: 4000 expert CartPole steps."""
    from ray_tpu_torch.rl import collect_dataset
    return collect_dataset("CartPole-v1", policy=CartPoleExpert(),
                           n_steps=n_steps, seed=0)


def mixed_dataset(n_steps=4000):
    """The MARWIL gate's dataset: half expert, half anti-expert steps."""
    from ray_tpu_torch.rl import collect_dataset, concat_samples
    return concat_samples([
        collect_dataset("CartPole-v1", policy=CartPoleExpert(),
                        n_steps=n_steps // 2, seed=0),
        collect_dataset("CartPole-v1", policy=CartPoleExpert(flip=True),
                        n_steps=n_steps // 2, seed=1)])


def qmix_jax_init():
    """The JAX package's seed-0 QMIX parameters on the two-step game, as
    ``tests/test_torch_rl_multi_agent.py`` saved them (and holds them
    equal to the JAX package's): the reference gate's start."""
    with np.load(QMIX_JAX_INIT) as z:
        flat = {k: z[k] for k in z.files}
    params = {}
    for key in sorted(flat):
        net, layer, leaf = key.split(".")
        layers = params.setdefault(net, {"layers": []})["layers"]
        while len(layers) <= int(layer):
            layers.append({})
        layers[int(layer)][leaf] = flat[key]
    return params


def ddppo_gate_config(device, backend="cpu"):
    """``tests/test_rl_extended.py:152-173``'s DD-PPO on CartPole (2
    workers, 4 envs x 100 steps each, 400 steps a worker an iteration, 6
    SGD steps, lr 3e-4, seed 0)."""
    from ray_tpu_torch.rl import DDPPO
    return (DDPPO.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=4,
                      rollout_fragment_length=100)
            .training(train_batch_size=400, num_sgd_iter=6, lr=3e-4,
                      collective_backend=backend)
            .resources(device=str(device))
            .debugging(seed=SEED))


@contextlib.contextmanager
def world_of_one(device):
    """A ``torch.distributed`` world of one rank in this process (NCCL on
    the card, gloo on the CPU), as phase 14 makes it."""
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
        **({"device_id": torch.device("cuda", torch.cuda.current_device())}
           if device.type == "cuda" else {}))
    try:
        yield
    finally:
        dist.destroy_process_group()


def parity_mesh_ppo(devices):
    """One ``sgd`` of phase 21's schedule (8 epochs x 3 minibatches of
    256) by the CPU learner and, on the card, by the learner over a
    ``data=1`` mesh of a world of one, held also bit for bit against the
    one-device learner on the card (it runs no collective at size 1, so it
    takes the one-device path)."""
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    from ray_tpu_torch.rl import RolloutWorker
    from ray_tpu_torch.rl.postprocessing import standardize
    from ray_tpu_torch.rl.ppo import PPOLearner
    from ray_tpu_torch.rl.sample_batch import SampleBatch, batch_to_device
    cfg = ppo_gate_config("cpu")
    worker = RolloutWorker("CartPole-v1", num_envs=8,
                           rollout_fragment_length=100, seed=SEED,
                           device="cpu")
    batch = worker.sample()
    batch[SampleBatch.ADVANTAGES] = standardize(batch[SampleBatch.ADVANTAGES])
    n = len(batch) // cfg.sgd_minibatch_size * cfg.sgd_minibatch_size
    batch = batch.slice(0, n)
    used = {k: batch[k] for k in (
        SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.ACTION_LOGP,
        SampleBatch.ADVANTAGES, SampleBatch.VALUE_TARGETS)}
    perms = _seeded_perms(n, cfg.num_sgd_iter, SEED + 23)
    weights = worker.get_weights()

    def schedule(learner):
        dev = learner.device
        return learner.sgd(batch_to_device(used, dev), 0.2,
                           [p.to(dev) for p in perms])

    out, learner = {}, None
    for dev in devices:
        if dev.type == "cpu" and dev is devices[0]:
            learner = PPOLearner(weights, cfg, False, device=dev)
            metrics = schedule(learner)
            out[dev.type] = (learner.get_weights(), metrics)
            continue
        with world_of_one(dev):
            mesh = build_mesh(MeshConfig(data=1), dev)
            learner = PPOLearner(weights, cfg, False, mesh=mesh)
            assert learner.device.type == dev.type and learner.mesh is mesh
        metrics = schedule(learner)
        single = PPOLearner(weights, cfg, False, device=learner.device)
        single_metrics = schedule(single)
        # A data=1 mesh runs no collective, so it takes the one-device
        # update: bit-equal parameters and metrics.
        leaves = list(zip(rl_tree_leaves(learner.params),
                          rl_tree_leaves(single.params)))
        assert leaves and all(torch.equal(a, b) for a, b in leaves), (
            "the data=1 mesh learner differs from the one-device learner")
        assert metrics == single_metrics, (metrics, single_metrics)
        log(f"[rl-multi] (1) the data=1 mesh learner equals the one-device "
            f"learner on {dev} bit for bit: {len(leaves)} parameters "
            f"(torch.equal) and {len(metrics)} metrics")
        out[dev.type] = (learner.get_weights(), metrics)
    return (out, weights, lambda: schedule(learner),
            cfg.num_sgd_iter * (n // cfg.sgd_minibatch_size))


def rl_tree_leaves(tree):
    from ray_tpu_torch.rl import models as rl_models
    return rl_models.tree_leaves(tree)


def parity_ddppo(devices):
    """One DD-PPO step of the gate's two workers (the ``cpu`` backend), each
    on its own fixed 400-step CartPole batch: the mean gradient, clip +
    Adam. Each worker lives on a thread of its own, which its collective
    group is bound to."""
    import concurrent.futures
    from ray_tpu_torch.rl import Policy, RolloutWorker, make_env
    from ray_tpu_torch.rl.ddppo import _DDPPOWorker
    from ray_tpu_torch.rl.ppo import _USED, AUX_KEYS
    from ray_tpu_torch.rl.sample_batch import batch_to_device
    cfg = ddppo_gate_config("cpu")
    kwargs = dict(env_name_or_maker="CartPole-v1", num_envs=4,
                  rollout_fragment_length=100, seed=SEED, device="cpu")
    init = Policy(make_env("CartPole-v1").spec, seed=SEED,
                  device="cpu").get_weights()
    batches = []
    for rank in range(2):
        w = RolloutWorker(worker_index=rank, **kwargs)
        w.set_weights(init)
        batches.append({k: v for k, v in w.sample().items() if k in _USED})
    made = []   # (pools, workers) of each device's pair

    def build(dev):
        pools = [concurrent.futures.ThreadPoolExecutor(1) for _ in range(2)]
        group = f"ddppo-phase23-{dev.type}-{len(made)}"
        workers = [f.result(timeout=60) for f in [
            pools[r].submit(_DDPPOWorker, kwargs, cfg.to_dict(), init, r, 2,
                            group, str(dev)) for r in range(2)]]
        arrays = [batch_to_device(b, dev) for b in batches]
        made.append((pools, workers))

        def step():
            return [f.result(timeout=60).tolist() for f in [
                pools[r].submit(workers[r].sgd_step, arrays[r], 0.2)
                for r in range(2)]]
        step.workers = workers
        return step

    def update(step, dev):
        auxes = step()
        w0, w1 = (w.get_weights() for w in step.workers)
        assert all(np.array_equal(a, b) for a, b in zip(
            rl_tree_leaves(w0), rl_tree_leaves(w1))), "DD-PPO lost lockstep"
        return w0, {f"{k}[{r}]": v for r in range(2)
                    for k, v in zip(AUX_KEYS, auxes[r])}

    out, step = _run_on(devices, build, update)

    def close_all():
        for pools, workers in made:
            for pool, w in zip(pools, workers):
                pool.submit(w.leave_group).result(timeout=60)
                pool.shutdown()
    return out, init, step, 1, close_all


def parity_qmix(devices):
    """One ``QMIXLearner.train`` (double Q, batch 128) on joint transitions
    replayed from 150 two-step episodes of a CPU run, from the host-drawn
    seed-0 init: the loss and ``q_tot_mean`` read back once."""
    from ray_tpu_torch.rl import QMIX, TwoStepCooperativeGameEnv
    from ray_tpu_torch.rl.qmix import QMIXLearner
    algo = (QMIX.get_default_config()
            .environment(lambda c: TwoStepCooperativeGameEnv(c))
            .resources(device="cpu").debugging(seed=SEED).build())
    for _ in range(150):
        algo._collect_episode()
    batch = algo._sample_batch()
    start = algo.learner.state()
    dims = (algo.obs_dim, len(algo.agent_ids), algo.n_actions,
            algo.state_dim)
    cfg = algo.algo_config

    def build(dev):
        learner = QMIXLearner(*dims, cfg, device=dev)
        learner.set_state(start)
        return learner

    def update(learner, dev):
        metrics = learner.train(batch)
        assert learner.host_reads == 1
        return learner.state()[0], metrics

    out, learner = _run_on(devices, build, update)
    return out, start[0], lambda: learner.train(batch), 1


def parity_offline(name):
    """One step of BC's, MARWIL's or CQL's learner at its gate's shape
    (batch 256; fcnet (64, 64), CQL's (256, 256)) on the gate's dataset,
    256 rows drawn by a seeded numpy generator, from a CPU policy's
    init."""
    def case(devices):
        import ray_tpu_torch.rl as rl
        from ray_tpu_torch.rl import Policy, SampleBatch, make_env
        from ray_tpu_torch.rl.dqn import EpsilonGreedyPolicy
        from ray_tpu_torch.rl.offline import (BCLearner, CQLLearner,
                                              MARWILLearner)
        from ray_tpu_torch.rl.sample_batch import batch_to_device
        cfg = getattr(rl, name).get_default_config()
        ds = mixed_dataset() if name == "MARWIL" else expert_dataset()
        idx = np.random.default_rng(SEED).integers(0, len(ds),
                                                   cfg.train_batch_size)
        cols = {"obs": SampleBatch.OBS, "act": SampleBatch.ACTIONS,
                "rew": SampleBatch.REWARDS, "nxt": SampleBatch.NEXT_OBS,
                "done": SampleBatch.TERMINATEDS}
        host = {k: np.asarray(ds[c])[idx] for k, c in cols.items()}
        if name == "MARWIL":
            host["ret"] = rl.MARWIL._mc_returns(ds, cfg.gamma)[idx]
        policy_cls = EpsilonGreedyPolicy if name == "CQL" else Policy
        init = policy_cls(make_env("CartPole-v1").spec, dict(cfg.model),
                          seed=SEED, device="cpu").get_weights()

        def build(dev):
            if name == "CQL":
                return CQLLearner(init, cfg, device=dev)
            cls = MARWILLearner if name == "MARWIL" else BCLearner
            return cls(init, cfg, False, device=dev)

        def step(learner):
            b = batch_to_device(host, learner.device)
            if name == "CQL":
                return learner.step(b)
            if name == "MARWIL":
                return learner.step(b["obs"], b["act"], b["ret"])
            return learner.step(b["obs"], b["act"])[None]

        keys = {"BC": ("bc_loss",), "MARWIL": ("policy_loss", "vf_loss"),
                "CQL": ("td_loss", "cql_penalty")}[name]

        def update(learner, dev):
            metrics = dict(zip(keys, step(learner).tolist()))
            if name == "MARWIL":
                metrics["ms"] = float(learner.ms)
            return learner.get_weights(), metrics

        out, learner = _run_on(devices, build, update)
        return out, init, lambda: step(learner).tolist(), 1
    return case


def rl_multi_cases():
    """Phase 23 (1)'s cases: (name, ``case(devices)``)."""
    return [
        ("PPOLearner over a data=1 mesh", parity_mesh_ppo),
        ("DD-PPO worker step, 2 workers, cpu backend", parity_ddppo),
        ("QMIXLearner, double Q", parity_qmix),
        ("BC step", parity_offline("BC")),
        ("MARWIL step", parity_offline("MARWIL")),
        ("CQL step, (256, 256)", parity_offline("CQL")),
    ]


def _with_close(case):
    """A phase 23 case as phase 22's ``rl_slice_parity`` takes it; its
    clean-up (DD-PPO's workers leave their groups), if any, is kept."""
    closers = []

    def run(devices):
        out = case(devices)
        if len(out) == 5:
            closers.append(out[4])
        return out[:4]
    return run, closers


def timed(obj, name, clock):
    """Wrap ``obj.name`` to add its host seconds and calls to ``clock``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            clock["s"] += time.perf_counter() - t0
            clock["calls"] += 1
    setattr(obj, name, wrapper)


def gate_result(passed, measured, wall_s, updates, learn_s, env_steps=None):
    return {"passed": passed, "measured": measured, "wall_s": wall_s,
            "updates": updates, "updates_per_s": updates / wall_s,
            "ms_per_update": 1e3 * learn_s / max(1, updates),
            "env_steps_per_s": (None if env_steps is None
                                else env_steps / wall_s)}


def gate_multi_agent_ppo(device):
    """``tests/test_rl.py:474-489``: independent PPO on the coordination
    game, 25 iterations, final episode_reward_mean > 15."""
    from ray_tpu_torch.rl import MultiAgentPPO
    algo = (MultiAgentPPO.get_default_config()
            .environment("CoordinationGame")
            .training(train_batch_size=200, sgd_minibatch_size=50,
                      num_sgd_iter=8, lr=3e-3, entropy_coeff=0.01)
            .resources(device=device).debugging(seed=SEED).build())
    clock = {"s": 0.0, "calls": 0}
    for ln in algo.learner.values():
        assert ln.device.type == torch.device(device).type
        timed(ln, "train", clock)
    t0 = time.perf_counter()
    try:
        for _ in range(25):
            r = algo.train()
    finally:
        algo.stop()
    wall = time.perf_counter() - t0
    updates = sum(ln.opt_state["count"] for ln in algo.learner.values())
    final = r["episode_reward_mean"]
    return gate_result(final > 15.0, f"final {final:.3f}", wall, updates,
                       clock["s"], r["timesteps_total"])


def _offline_algo(cls, device, ds, iters, n_episodes, **training):
    """``iters`` iterations of 64 updates, then the greedy evaluation. ->
    (the last result, the evaluation, learning seconds, updates)."""
    algo = (cls.get_default_config().environment("CartPole-v1")
            .training(input_=ds, n_updates_per_iter=64, **training)
            .resources(device=device).debugging(seed=SEED).build())
    assert algo.learner.device.type == torch.device(device).type
    t0 = time.perf_counter()
    try:
        for _ in range(iters):
            r = algo.train()
        learn = time.perf_counter() - t0
        score = algo.evaluate(n_episodes=n_episodes)
    finally:
        algo.stop()
    return r, score, learn, iters * 64


def gate_bc(device):
    """``tests/test_rl.py:554-570``: BC on 4000 expert steps, 10
    iterations of 64 updates, evaluation (3 episodes) >= 300."""
    from ray_tpu_torch.rl import BC
    r, score, learn, updates = _offline_algo(BC, device, expert_dataset(),
                                             10, 3)
    return gate_result(score >= 300.0, f"evaluation {score:.1f}", learn,
                       updates, learn)


def gate_cql(device):
    """``tests/test_rl.py:573-585``: CQL on the same data, 15 iterations,
    penalty < 2 and evaluation (3 episodes) >= 300."""
    from ray_tpu_torch.rl import CQL
    r, score, learn, updates = _offline_algo(CQL, device, expert_dataset(),
                                             15, 3, cql_alpha=1.0)
    return gate_result(r["cql_penalty"] < 2.0 and score >= 300.0,
                       f"penalty {r['cql_penalty']:.4f}, evaluation "
                       f"{score:.1f}", learn, updates, learn)


def gate_marwil(device):
    """``tests/test_rl_extended.py:376-396``: BC and MARWIL on mixed
    data, 12 iterations each, evaluation (5 episodes): MARWIL > 150 and
    > BC + 30."""
    from ray_tpu_torch.rl import BC, MARWIL
    ds = mixed_dataset()
    scores, learn = {}, 0.0
    for cls in (BC, MARWIL):
        algo = (cls.get_default_config().environment("CartPole-v1")
                .training(input_=ds, n_updates_per_iter=64)
                .resources(device=device).debugging(seed=SEED).build())
        t0 = time.perf_counter()
        try:
            for _ in range(12):
                algo.train()
            learn += time.perf_counter() - t0
            scores[cls.__name__] = algo.evaluate(n_episodes=5)
        finally:
            algo.stop()
    m, b = scores["MARWIL"], scores["BC"]
    return gate_result(m > 150.0 and m > b + 30.0,
                       f"MARWIL {m:.1f}, BC {b:.1f}", learn, 2 * 12 * 64,
                       learn)


def gate_qmix(device):
    """``tests/test_rl_extended.py:104-116``: QMIX on the two-step game,
    seed 0, 90 iterations, greedy return (20 episodes) >= 7.9, from the
    JAX package's seed-0 parameters (``qmix_jax_init``)."""
    from ray_tpu_torch.rl import QMIX, TwoStepCooperativeGameEnv
    algo = (QMIX.get_default_config()
            .environment(lambda c: TwoStepCooperativeGameEnv(c))
            .resources(device=device).debugging(seed=SEED).build())
    learner = algo.learner
    assert learner.device.type == torch.device(device).type
    init = qmix_jax_init()
    learner.set_state((init, init, None, 0))
    clock = {"s": 0.0, "calls": 0}
    timed(learner, "train", clock)
    t0 = time.perf_counter()
    for _ in range(90):
        r = algo.train()
    wall = time.perf_counter() - t0
    reads = learner.act_reads / r["timesteps_total"]
    greedy = algo.greedy_joint_return(20)
    return gate_result(greedy >= 7.9, f"greedy return {greedy:.3f}, "
                       f"{reads:.2f} device->host reads of act an env step",
                       wall, learner.steps, clock["s"], r["timesteps_total"])


def gate_ddppo(device):
    """``tests/test_rl_extended.py:152-173``: DD-PPO on CartPole, 2
    workers, 35 iterations, final > max(40, first + 10), the workers'
    parameters bit-identical after."""
    import ray_tpu_torch as rt
    rt.init(num_cpus=8)
    try:
        algo = ddppo_gate_config(device).build()
        rewards, learn = [], 0.0
        t0 = time.perf_counter()
        try:
            for _ in range(35):
                r = algo.train()
                learn += r["learn_time_s"]
                if "episode_reward_mean" in r:
                    rewards.append(r["episode_reward_mean"])
            wall = time.perf_counter() - t0
            ws = rt.get([w.get_weights.remote() for w in algo._workers],
                        timeout=60)
        finally:
            algo.stop()
    finally:
        rt.shutdown()
    lockstep = all(np.array_equal(a, b) for a, b in zip(
        rl_tree_leaves(ws[0]), rl_tree_leaves(ws[1])))
    first, final = rewards[0], rewards[-1]
    # each worker takes every step: updates are steps of the pair
    return gate_result(final > max(40.0, first + 10) and lockstep,
                       f"first {first:.2f}, final {final:.2f}, lockstep "
                       f"{lockstep}", wall, 35 * 6, learn,
                       r["timesteps_total"])


# Phase 23 (2): name -> (the gate's function, its check), longest first.
RL_MULTI_GATES = {
    "DD-PPO, CartPole, 2 workers": (
        gate_ddppo, "final > max(40, first + 10), lockstep"),
    "QMIX, two-step game": (gate_qmix, "greedy return >= 7.9"),
    "multi-agent PPO, coordination game": (gate_multi_agent_ppo,
                                           "final > 15"),
    "MARWIL against BC, mixed CartPole data": (
        gate_marwil, "MARWIL > 150 and > BC + 30"),
    "CQL, expert CartPole data": (gate_cql,
                                  "penalty < 2, evaluation >= 300"),
    "BC, expert CartPole data": (gate_bc, "evaluation >= 300"),
}


def run_multi_gate(name, device):
    """Phase 23 (2), one gate in a process of its own: the learners on
    ``device``, rollouts on one intra-op CPU thread."""
    torch.set_num_threads(1)
    return RL_MULTI_GATES[name][0](device)


def ddppo_nccl(device, iters=DDPPO_NCCL_ITERS):
    """Phase 23 (3): the DD-PPO gate's config with the ``nccl`` backend,
    both workers folded onto ``device``, ``iters`` iterations under
    ``init()``: every allreduce gets the flat gradient on the device and
    is timed on the host clock between two synchronizes (the rendezvous
    with the other worker included). -> (allreduce ms each, calls,
    iteration seconds)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import collective as col
    original = col.allreduce
    times, sizes, lock = [], set(), threading.Lock()

    def timed_allreduce(tensor, *args, **kwargs):
        assert isinstance(tensor, torch.Tensor) and \
            tensor.device.type == device.type, tensor
        sync = torch.cuda.synchronize if device.type == "cuda" else (
            lambda: None)
        sync()
        t0 = time.perf_counter()
        out = original(tensor, *args, **kwargs)
        sync()
        with lock:
            times.append(time.perf_counter() - t0)
            sizes.add(tensor.numel())
        return out

    col.allreduce = timed_allreduce
    rt.init(num_cpus=8)
    try:
        algo = ddppo_gate_config(device, backend="nccl").build()
        t0 = time.perf_counter()
        try:
            for _ in range(iters):
                algo.train()
            seconds = time.perf_counter() - t0
            ws = rt.get([w.get_weights.remote() for w in algo._workers],
                        timeout=60)
        finally:
            algo.stop()
    finally:
        rt.shutdown()
        col.allreduce = original
    assert all(np.array_equal(a, b) for a, b in zip(
        rl_tree_leaves(ws[0]), rl_tree_leaves(ws[1]))), "nccl lockstep"
    assert len(times) == 2 * iters * 6 and len(sizes) == 1, (times, sizes)
    return 1e3 * statistics.median(times), len(times), sizes.pop(), seconds


def rl_multi_phase(fa, device, card, gates):
    """Phase 23: the mesh PPO learner, DD-PPO, multi-agent PPO, QMIX, BC,
    MARWIL and CQL with their learners on the card; ``gates`` holds the
    results of (2), which ran in phase 22's pool. Returns nothing: no
    flash kernel runs, and the launch counters must not move."""
    t_phase = time.perf_counter()
    # the process's one-time costs first: each case once on the card (the
    # learners' kernels' code, a second NCCL world, the workers' threads'
    # cuBLAS handles)
    free_device_caches()
    warm_before = torch.cuda.mem_get_info(device)[0]
    for _, case in rl_multi_cases():
        run, closers = _with_close(case)
        run((device,))
        for close in closers:
            close()
    free_device_caches()
    warm = warm_before - torch.cuda.mem_get_info(device)[0]
    free_before = torch.cuda.mem_get_info(device)[0]
    counts = launch_counts(fa)

    # (1) each new learner on the card against itself on the CPU
    cases, closers = [], []
    for name, case in rl_multi_cases():
        run, closer = _with_close(case)
        cases.append((name, run))
        closers.append(closer)
    parity = rl_slice_parity(device, cases)
    for closer in closers:
        for close in closer:
            close()
    for name, (p_err, m_err, moved, share), seconds, ms, _ in parity:
        log(f"[rl-multi] (1) {name}: card against CPU (TF32 off), largest "
            f"parameter difference {p_err:.3e} (the parameters moved up to "
            f"{moved:.3e}: {share:.2e} of it), largest metric difference "
            f"{m_err:.3e}, at rtol {RL_RTOL}, atol {RL_ATOL}; {seconds:.1f} "
            f"s")
        log(f"[times] {card}: {name}: {ms:.3f} ms an optimizer step on the "
            f"card alone (host clock, {RL_TIMED_STEPS} steps or more)")
    del parity, cases

    # (2) the learning gates, learners on the card, each in a spawned
    # process of phase 22's pool
    for name, r in gates.items():
        check = RL_MULTI_GATES[name][1]
        assert r["passed"], (name, check, r)
        rate = ("" if r["env_steps_per_s"] is None else
                f"{r['env_steps_per_s']:.1f} env-steps/s, ")
        log(f"[rl-multi] (2) {name}, learners on the card: {r['measured']}:"
            f" the gate {check} holds; {r['wall_s']:.1f} s")
        log(f"[times] {card}: {name}, {RL_GATE_PROCESSES} gates at a time: "
            f"{rate}{r['updates_per_s']:.1f} updates/s ({r['updates']} "
            f"updates, {r['ms_per_update']:.3f} ms each on the host clock)")
    log(f"[rl-multi] (2) {len(gates)} gates, run in phase 22's pool")

    # (3) DD-PPO over the nccl backend, the two workers folded on the card
    ms, calls, floats, seconds = ddppo_nccl(device)
    log(f"[rl-multi] (3) DD-PPO, collective_backend='nccl', 2 workers folded"
        f" on the card, {DDPPO_NCCL_ITERS} iterations in {seconds:.1f} s: "
        f"the workers' parameters bit-identical; {calls} allreduces of the "
        f"flat gradient on the card")
    log(f"[times] {card}: DD-PPO nccl allreduce (2 ranks folded on one card,"
        f" {floats} floats): {ms:.3f} ms median of {calls} on the host "
        f"clock, the rendezvous included")

    # (4) the card's memory is back, and no flash kernel ran
    assert launch_counts(fa) == counts, (launch_counts(fa), counts)
    free_after = None
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        free_device_caches()
        free_after = torch.cuda.mem_get_info(device)[0]
        if free_before - free_after <= PROCESS_MEMORY_SLACK:
            break
        time.sleep(0.2)
    assert free_before - free_after <= PROCESS_MEMORY_SLACK, (
        free_before, free_after)
    log(f"[rl-multi] (4) the card's free memory {free_before} bytes before "
        f"(1), {free_after} after (the one-time costs, {warm} bytes, paid "
        f"before); the flash launch counters did not move; phase 23 in "
        f"{time.perf_counter() - t_phase:.1f} s")


# -- phase 24: the leaf libraries and the autoscaler --------------------------


def lm_answers(cfg, params, requests):
    """Phase 24's answer to each request: the argmax of its last-token
    logits, the request alone and right-padded to its length bucket; one
    int64 tensor on the weights' device."""
    return padded_answers(cfg, params, wf_pad(requests))


def padded_answers(cfg, params, padded):
    """``lm_answers`` of requests already padded one by one."""
    from ray_tpu_torch.models import transformer
    device = next(iter(transformer.leaves(params))).device
    out = []
    with torch.inference_mode():
        for batch in padded:
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in batch.items()}
            out.append(last_token_logits(cfg, params, batch).argmax(-1))
    return torch.cat(out)


def seeded_lm(device, width):
    """Phase 5's f32 model from its seed on ``device``: (config, params)."""
    return serve_inputs(device, width, 0)[3:]


def granted_device(device_type):
    """The card this task or actor was granted (the CPU when the phase is
    rehearsed there)."""
    import ray_tpu_torch
    if device_type != "cuda":
        return torch.device("cpu")
    (device,) = ray_tpu_torch.get_runtime_context().get_gpu_devices()
    return device


def no_tf32():
    """TF32 off in this process, as in the script's. Imported here: a
    ``torch.backends`` submodule named through the global ``torch`` would
    make the caller unpicklable by value."""
    from torch.backends import cudnn
    from torch.backends.cuda import matmul
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False


def wf_pad(requests):
    """(a) step 1, on the host: each request padded to its bucket."""
    return [pad_requests([r]) for r in requests]


def wf_forward(padded, width, device_type):
    """(a) step 2: the model from its seed on the card; each request's
    answer, one CUDA tensor."""
    cfg, params = seeded_lm(granted_device(device_type), width)
    return padded_answers(cfg, params, padded)


def wf_reduce(answers, marker):
    """(a) step 3: fails on its first run (which leaves ``marker``), then
    passes the answers on with their count."""
    import os
    if not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write("failed once\n")
        raise RuntimeError("the reducer's first run fails")
    return {"answers": answers, "n": int(answers.numel())}


def read_workflow_output(base, workflow_id):
    """(a) in a process without a card: the stored output, printed as a
    JSON line."""
    from ray_tpu_torch import workflow
    workflow.init(storage_base_dir=base)
    out = workflow.get_output(workflow_id)
    t = out["answers"]
    print("WORKFLOW_OUTPUT " + json.dumps({
        "type": type(t).__name__, "device": str(t.device),
        "cuda_available": torch.cuda.is_available(),
        "values": t.tolist(), "n": out["n"]}), flush=True)


class ClientLM:
    """User code for phase 24 (b): phase 5's model from its seed in a
    ``num_gpus=1`` actor made by a Ray Client; each answer a tensor on the
    granted card."""

    def __init__(self, width, device_type):
        import ray_tpu_torch
        from ray_tpu_torch.air import TorchPredictor
        no_tf32()
        self.granted = ray_tpu_torch.get_runtime_context().get_gpu_devices()
        device = granted_device(device_type)
        cfg, params = seeded_lm(device, width)
        self.cfg = cfg
        self.predictor = TorchPredictor(
            params, functools.partial(last_token_logits, cfg), device=device)

    def devices(self):
        return [str(d) for d in self.granted]

    def answer(self, request):
        return lm_answers(self.cfg, self.predictor.params, [request])


def client_main(port, width, device_type):
    """(b) the client process (no card): make the actor, send the requests
    from one thread and from ``CLIENT_THREADS``, print one JSON line, then
    hold the actor until a line arrives on stdin."""
    import concurrent.futures

    import cloudpickle

    from ray_tpu_torch.util.client import connect
    # this module's classes and functions go by value: the server's
    # process runs the script as __main__
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    api = connect(f"127.0.0.1:{port}")
    _, _, requests = seeded_requests(width, N_REQUESTS)
    t0 = time.perf_counter()
    lm = api.remote(ClientLM, num_gpus=1,
                    max_concurrency=CLIENT_THREADS).remote(width, device_type)
    devices = api.get(lm.devices.remote(), timeout=SUBPROCESS_TIMEOUT_S)
    ready_s = time.perf_counter() - t0
    api.get(lm.answer.remote(requests[0]), timeout=SUBPROCESS_TIMEOUT_S)
    t0 = time.perf_counter()
    one = [api.get(lm.answer.remote(r), timeout=SUBPROCESS_TIMEOUT_S)
           for r in requests]
    one_s = time.perf_counter() - t0

    def ask(r):
        return api.get(lm.answer.remote(r), timeout=SUBPROCESS_TIMEOUT_S)

    with concurrent.futures.ThreadPoolExecutor(CLIENT_THREADS) as ex:
        # a first pass warms the actor's threads (each thread's first
        # matmul makes its cuBLAS handles), then the measured one
        t0 = time.perf_counter()
        list(ex.map(ask, requests))
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        many = list(ex.map(ask, requests))
        many_s = time.perf_counter() - t0
    print("CLIENT " + json.dumps({
        "devices": devices, "cuda_available": torch.cuda.is_available(),
        "types": sorted({type(a).__name__ for a in one + many}),
        "answer_devices": sorted({str(a.device) for a in one + many}),
        "one": torch.cat(one).tolist(), "many": torch.cat(many).tolist(),
        "ready_s": ready_s, "one_s": one_s, "first_s": first_s,
        "many_s": many_s}), flush=True)
    sys.stdin.readline()
    api.kill(lm)
    api.disconnect()


def run_python(code, env=None, timeout_s=SUBPROCESS_TIMEOUT_S):
    """``python -c code`` from the repository's root; its stdout."""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=timeout_s)
    assert out.returncode == 0, (out.returncode, out.stdout[-3000:],
                                 out.stderr[-3000:])
    return out.stdout


def no_card_env():
    import os
    return dict(os.environ, CUDA_VISIBLE_DEVICES="")


def json_line(text, tag):
    lines = [ln for ln in text.splitlines() if ln.startswith(tag + " ")]
    assert len(lines) == 1, (tag, text[-3000:])
    return json.loads(lines[0][len(tag) + 1:])


def wait_free_memory(device, free_before, timeout_s=30.0):
    """The card's free memory once it is back within
    ``PROCESS_MEMORY_SLACK`` of ``free_before``; fails after
    ``timeout_s``."""
    free_after = None
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        free_device_caches()
        free_after = torch.cuda.mem_get_info(device)[0]
        if free_before - free_after <= PROCESS_MEMORY_SLACK:
            break
        time.sleep(0.2)
    assert free_before - free_after <= PROCESS_MEMORY_SLACK, (
        free_before, free_after)
    return free_after


def leaf_phase(fa, device, card, direct_rps, width=SERVE_WIDTH,
               autoscale_type=None, autoscale_task=None):
    """Phase 24: the leaf libraries (workflow, Ray Client, Pool and joblib,
    jobs, the state API) and the autoscaler, each driving phase 5's model
    on the card. ``autoscale_type`` and ``autoscale_task``: the node type
    (f) launches and the task's resources (default: one GPU). Returns the
    flash forward kernel's launches, counted in every process, the direct
    answers and the f32 rates: {"launches", "want", "direct_rps",
    "client_rps"}."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.models import transformer

    t_phase = time.perf_counter()
    root = REPO / LEAF_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    _, lengths, requests = seeded_requests(width, N_REQUESTS)
    n_layers = width["n_layers"]
    per_pass = n_layers * len(requests)
    free_device_caches()

    # the direct answers: phase 5's model from its seed, each request alone
    cfg, params = seeded_lm(device, width)
    lm_answers(cfg, params, requests[:1])
    fa.launches = 0
    t0 = time.perf_counter()
    want = lm_answers(cfg, params, requests)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    assert fa.launches == per_pass, (fa.launches, per_pass)
    launches = fa.launches
    log(f"[leaf] {transformer.num_params(params) / 1e6:.1f} M parameters; "
        f"the direct answers: {len(requests)} requests alone, f32, "
        f"{per_pass} forward launches, {len(requests) / direct_s:.2f} "
        f"requests/s")

    config = {k: str(REPO / v) for k, v in RUNTIME_CONFIG.items()}
    rt.init(num_cpus=8, _system_config=config)
    try:
        assert rt.cluster_resources().get("GPU") == torch.cuda.device_count()
        launches += workflow_step(rt, fa, device, card, want, root, width,
                                  per_pass)
        launches += pool_step(rt, fa, cfg, params, requests, want, per_pass)
        got, client_rps = client_step(rt, fa, card, want, width,
                                      direct_rps, len(requests) / direct_s,
                                      device)
        launches += got
    finally:
        rt.shutdown()
    del params
    launches += job_step(device, root)
    launches += autoscaler_step(rt, fa, device, card, want, width,
                                autoscale_type, autoscale_task)
    log(f"[leaf] phase 24 in {time.perf_counter() - t_phase:.1f} s; "
        f"{launches} forward launches in all its processes")
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "want": want.tolist(),
            "direct_rps": len(requests) / direct_s, "client_rps": client_rps}


def workflow_step(rt, fa, device, card, want, root, width, per_pass):
    """(a) a workflow whose reducer fails; resume; a reader without a
    card."""
    from ray_tpu_torch import workflow
    base, marker = str(root / "workflows"), str(root / "reducer-failed")
    workflow.init(storage_base_dir=base)
    _, _, requests = seeded_requests(width, N_REQUESTS)
    pad, fwd, red = (rt.remote(wf_pad), rt.remote(num_gpus=1)(wf_forward),
                     rt.remote(wf_reduce))
    dag = red.bind(fwd.bind(pad.bind(requests), width, device.type), marker)
    fa.launches = 0
    t0 = time.perf_counter()
    try:
        workflow.run(dag, workflow_id="lm")
    except workflow.WorkflowExecutionError as e:
        failed = str(e.cause).splitlines()[0][:80]
    else:
        raise AssertionError("the reducer's first run did not fail")
    run_s = time.perf_counter() - t0
    assert workflow.get_status("lm") == "FAILED"
    assert fa.launches == per_pass, (fa.launches, per_pass)
    stored = sorted(workflow.WorkflowStorage("lm", base).list_task_results())
    assert stored == ["0000_wf_pad", "0001_wf_forward"], stored
    before = fa.launches
    t0 = time.perf_counter()
    out = workflow.resume("lm")
    resume_s = time.perf_counter() - t0
    assert fa.launches == before, "the resume ran the forward again"
    assert workflow.get_status("lm") == "SUCCESS"
    got = out["answers"]
    assert got.device.type == device.type and torch.equal(got, want), (
        got, want)
    assert out["n"] == len(requests)
    log(f"[leaf] (a) workflow: pad (host), a num_gpus=1 forward (the model "
        f"from its seed, {per_pass} launches), a reducer: the run ended "
        f"FAILED ({failed}) with {stored} stored; resume() answered on "
        f"{got.device}, equal to the direct answers, without a forward "
        f"launch")
    t0 = time.perf_counter()
    seen = json_line(run_python(
        "import chip_smoke; chip_smoke.read_workflow_output("
        f"{base!r}, 'lm')", env=no_card_env()), "WORKFLOW_OUTPUT")
    read_s = time.perf_counter() - t0
    assert seen["type"] == "Tensor" and seen["device"] == "cpu", seen
    assert not seen["cuda_available"], seen
    assert seen["values"] == want.tolist() and seen["n"] == len(requests)
    log(f"[leaf] (a) get_output in a process with CUDA_VISIBLE_DEVICES=\"\":"
        f" a CPU tensor of the same {len(requests)} values")
    log(f"[times] {card}: workflow run to the failure {run_s:.3f} s, "
        f"resume {resume_s:.3f} s, the reader process {read_s:.2f} s (host "
        f"clock)")
    return fa.launches


def pool_step(rt, fa, cfg, params, requests, want, per_pass):
    """(c) ``Pool`` with half a GPU a task, then the joblib backend."""
    from ray_tpu_torch.experimental import state
    from ray_tpu_torch.util.multiprocessing import Pool

    answer = functools.partial(lm_answers, cfg, params)

    def one(r):
        return answer([r])

    finished = state.summarize_tasks()["by_state"].get("FINISHED", 0)
    fa.launches = 0
    t0 = time.perf_counter()
    with Pool(2, ray_remote_args={"num_gpus": 0.5}) as pool:
        got = pool.map(one, requests, chunksize=POOL_CHUNKSIZE)
    pool_s = time.perf_counter() - t0
    got = torch.cat(got)
    assert torch.equal(got, want), (got, want)
    assert fa.launches == per_pass, (fa.launches, per_pass)
    n_chunks = math.ceil(len(requests) / POOL_CHUNKSIZE)
    counted = state.summarize_tasks()["by_state"].get("FINISHED", 0)
    assert counted - finished == n_chunks, (counted, finished, n_chunks)
    launches = fa.launches
    log(f"[leaf] (c) Pool(2, ray_remote_args={{'num_gpus': 0.5}}).map: "
        f"{len(requests)} answers in {n_chunks} tasks, equal to the direct "
        f"answers; {per_pass} forward launches; summarize_tasks counted "
        f"{counted - finished} more FINISHED tasks; {pool_s:.3f} s")
    try:
        import joblib
    except ImportError:
        log("[leaf] (c) joblib is not installed here: its backend was not "
            "run")
        return launches
    from ray_tpu_torch.util.joblib import register_ray_tpu
    register_ray_tpu()
    fa.launches = 0
    t0 = time.perf_counter()
    with joblib.parallel_backend("ray_tpu", n_jobs=2):
        got = joblib.Parallel()(joblib.delayed(one)(r) for r in requests)
    job_s = time.perf_counter() - t0
    assert torch.equal(torch.cat(got), want)
    assert fa.launches == per_pass, (fa.launches, per_pass)
    log(f"[leaf] (c) joblib {joblib.__version__}, backend 'ray_tpu', "
        f"n_jobs=2: the same answers, {per_pass} forward launches; "
        f"{job_s:.3f} s")
    return launches + fa.launches


def client_step(rt, fa, card, want, width, direct_rps, direct_f32_rps,
                device):
    """(b) a Ray Client in a process without a card drives a ``num_gpus=1``
    actor here; (e) the state API while the actor lives."""
    from ray_tpu_torch.experimental import state
    from ray_tpu_torch.util.client.server import ClientServer
    server = ClientServer(port=0)
    fa.launches = 0
    err_path = REPO / LEAF_DIR / "client.err"
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.client_main("
             f"{server.port}, {width!r}, {device.type!r})"],
            cwd=str(REPO), env=no_card_env(), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=err_file, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("CLIENT "):
                break
        assert lines and lines[-1].startswith("CLIENT "), (
            "".join(lines)[-3000:], err_path.read_text()[-3000:])
        seen = json_line("".join(lines), "CLIENT")
        # (e) the state API while the client's actor lives
        actors = [a for a in state.list_actors()
                  if a["class_name"] == "ClientLM"]
        nodes = state.list_nodes()
        proc.stdin.write("\n")
        proc.stdin.flush()
        proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        server.stop()
    assert proc.returncode == 0, (proc.returncode,
                                  err_path.read_text()[-3000:])
    want_list = want.tolist()
    assert seen["one"] == want_list and seen["many"] == want_list, seen
    assert seen["types"] == ["Tensor"] and seen["answer_devices"] == [
        "cpu"], seen
    assert not seen["cuda_available"], seen
    assert seen["devices"] == [str(torch.device(device.type, 0))] or (
        device.type == "cpu"), seen
    n = len(want_list)
    per_pass = width["n_layers"] * n
    assert fa.launches == width["n_layers"] + 3 * per_pass, (
        fa.launches, per_pass)
    log(f"[leaf] (b) Ray Client from a process with CUDA_VISIBLE_DEVICES="
        f"\"\": a num_gpus=1 actor holding a TorchPredictor, granted "
        f"{seen['devices']}; {n} requests from 1 thread and from "
        f"{CLIENT_THREADS}: answers equal to the direct ones, each a CPU "
        f"tensor; {fa.launches} forward launches here (a warm-up request, "
        f"a pass from 1 thread, a warm-up pass and a pass from "
        f"{CLIENT_THREADS})")
    log(f"[times] {card}: Ray Client, f32, one request a call: "
        f"{n / seen['one_s']:.2f} requests/s from 1 thread, "
        f"{n / seen['many_s']:.2f} from {CLIENT_THREADS} (their first "
        f"pass {n / seen['first_s']:.2f}); the direct "
        f"answers here {direct_f32_rps:.2f}; phase 5 direct (bf16, batched)"
        f" {direct_rps:.2f}; the actor ready in {seen['ready_s']:.2f} s")
    assert len(actors) == 1 and actors[0]["state"] == "ALIVE", actors
    (node,) = [r for r in nodes if r["node_id"] == actors[0]["node_id"]]
    total, avail = node["resources_total"], node["resources_available"]
    assert total.get("GPU") == 1.0 and avail.get("GPU", 0.0) == 0.0, node
    log(f"[leaf] (e) state API while the client's actor lived: list_actors "
        f"shows ClientLM ALIVE on node {node['node_id'][:8]}, whose "
        f"list_nodes row has GPU {total['GPU']} in total and "
        f"{avail.get('GPU', 0.0)} available (the actor's grant); "
        f"summarize_tasks: {state.summarize_tasks()['by_state']}")
    return fa.launches, {"one": n / seen["one_s"],
                         f"from {CLIENT_THREADS}": n / seen["many_s"]}


def job_step(device, root):
    """(d) ``JobManager``: the entry forward in a job, then a job that
    holds the card until ``stop_job``."""
    import os

    from ray_tpu_torch.entry import CONFIG, entry
    from ray_tpu_torch.job import JobManager, JobStatus
    fn, args = entry(device)
    mine = float(fn(*args).double().sum())
    del fn, args
    mgr = JobManager(job_dir=str(root / "jobs"))
    code = ("import importlib, torch; "
            "from ray_tpu_torch.entry import entry; "
            "fa = importlib.import_module('ray_tpu_torch.ops.flash_attention'); "
            f"fn, args = entry({device.type!r}); "
            "print('CHECKSUM', repr(float(fn(*args).double().sum())), "
            "'LAUNCHES', fa.launches, flush=True)")
    t0 = time.perf_counter()
    job = mgr.submit_job(entrypoint=f"{sys.executable} -c \"{code}\"",
                         cwd=str(REPO))
    status = mgr.wait_until_finished(job, timeout=SUBPROCESS_TIMEOUT_S)
    job_s = time.perf_counter() - t0
    logs = mgr.get_job_logs(job)
    assert status == JobStatus.SUCCEEDED, (status, logs[-3000:])
    (line,) = [ln for ln in logs.splitlines() if ln.startswith("CHECKSUM")]
    _, checksum, _, launches = line.split()
    assert float(checksum) == mine, (checksum, mine)
    assert int(launches) == CONFIG.n_layers, line
    log(f"[leaf] (d) a job running entry()'s forward: SUCCEEDED in "
        f"{job_s:.2f} s, its log's checksum {checksum} equal to this "
        f"process's, {launches} forward launches in the job's process")

    free_device_caches()
    free_before = torch.cuda.mem_get_info(device)[0] \
        if device.type == "cuda" else 0
    hold = ("import time, torch; "
            f"x = torch.empty({JOB_HOLD_BYTES}, dtype=torch.uint8, "
            f"device={device.type!r}); "
            "print('HOLDING', flush=True); time.sleep(600)")
    held = mgr.submit_job(entrypoint=f"{sys.executable} -c \"{hold}\"",
                          cwd=str(REPO))
    deadline = time.monotonic() + SUBPROCESS_TIMEOUT_S
    while "HOLDING" not in mgr.get_job_logs(held):
        assert mgr.get_job_status(held) == JobStatus.RUNNING, (
            mgr.get_job_logs(held)[-3000:])
        assert time.monotonic() < deadline, "the holding job never held"
        time.sleep(0.1)
    free_held = torch.cuda.mem_get_info(device)[0] \
        if device.type == "cuda" else 0
    assert free_before - free_held >= JOB_HOLD_BYTES or (
        device.type == "cpu"), (free_before, free_held)
    t0 = time.perf_counter()
    assert mgr.stop_job(held)
    assert mgr.wait_until_finished(held, timeout=60) == JobStatus.STOPPED
    while mgr.get_job_info(held).end_time is None:
        assert time.perf_counter() - t0 < 60, "the stopped job lives on"
        time.sleep(0.05)
    free_after = wait_free_memory(device, free_before) \
        if device.type == "cuda" else 0
    log(f"[leaf] (d) a job holding {JOB_HOLD_BYTES} bytes on the card: "
        f"stop_job ended it STOPPED (return code "
        f"{mgr.get_job_info(held).return_code}) in "
        f"{time.perf_counter() - t0:.2f} s; the card's free memory "
        f"{free_before} bytes before, {free_held} while it held, "
        f"{free_after} after; the jobs inherited this process's "
        f"CUDA_VISIBLE_DEVICES ({os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
    return int(launches)


def autoscaled_answers(width, device_type):
    """(f) in the daemon the autoscaler started: the model from its seed on
    its card, and the answers with this process's forward launches."""
    no_tf32()
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    device = granted_device(device_type)
    cfg, params = seeded_lm(device, width)
    _, _, requests = seeded_requests(width, N_REQUESTS)
    before = fa.launches
    answers = lm_answers(cfg, params, requests)
    return answers, fa.launches - before


def autoscaler_step(rt, fa, device, card, want, width, node_type=None,
                    task=None):
    """(f) a ``StandardAutoscaler`` over a ``ProcessCluster`` whose daemon
    owns no card: a GPU task makes it start a GPU daemon, which it
    terminates once idle."""
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.autoscaler import AutoscalerConfig, StandardAutoscaler
    from ray_tpu_torch.cluster_utils import ProcessCluster
    node_type = node_type or {"CPU": 2, "GPU": 1}
    task = task or {"num_gpus": 1}
    free_device_caches()
    free_before = torch.cuda.mem_get_info(device)[0] \
        if device.type == "cuda" else 0
    cluster = ProcessCluster(num_daemons=1, num_cpus=2)
    procs = [cluster.state_proc] + [d["proc"] for d in cluster.daemons]
    try:
        rt.init(address=cluster.address)
        try:
            runtime = worker.global_worker().runtime
            provider = cluster.node_provider({"gpu": node_type})
            scaler = StandardAutoscaler(
                AutoscalerConfig(node_types={"gpu": node_type},
                                 min_workers=0, max_workers=1,
                                 idle_timeout_s=AUTOSCALE_IDLE_S),
                provider, runtime=runtime)
            t0 = time.perf_counter()
            ref = rt.remote(**task)(autoscaled_answers).remote(
                width, device.type)
            while not scaler.update()["launched"]:
                assert time.perf_counter() - t0 < 60, "no launch"
                time.sleep(0.1)
            (pid,) = provider.non_terminated_nodes()
            while True:
                try:
                    provider.runtime_node_id(pid)
                    break
                except KeyError:
                    assert time.perf_counter() - t0 < 60, "not registered"
                    time.sleep(0.05)  # raylint: allow(bare-retry) deadline-bounded registration poll, not a failure retry
            registered_s = time.perf_counter() - t0
            procs += [d["proc"] for d in cluster.daemons]
            # update() goes on while the task runs, as a monitor's would:
            # it must leave the busy daemon alone, and it restarts the
            # daemon's idle clock
            passes = 0
            while not rt.wait([ref], timeout=0.2)[0]:
                assert not scaler.update()["terminated"], "killed busy"
                passes += 1
                assert time.perf_counter() - t0 < 600, "no answer"
            answers, daemon_launches = rt.get(ref, timeout=600)
            answer_s = time.perf_counter() - t0
            assert answers.device.type == device.type, answers.device
            assert torch.equal(answers, want), (answers, want)
            assert daemon_launches == width["n_layers"] * N_REQUESTS
            del answers
            t1 = time.perf_counter()
            while not scaler.update()["terminated"]:
                assert time.perf_counter() - t1 < 60, "no scale-down"
                time.sleep(0.1)
            down_s = time.perf_counter() - t0
            assert provider.non_terminated_nodes() == []
            free_after = wait_free_memory(device, free_before) \
                if device.type == "cuda" else 0
            scaler.stop()
        finally:
            rt.shutdown()
    finally:
        cluster.shutdown()
    left = [p.pid for p in procs if p.poll() is None]
    assert not left, left
    log(f"[leaf] (f) StandardAutoscaler over a ProcessCluster whose daemon "
        f"owns no card: a {task} task made update() launch one "
        f"{node_type} daemon; {passes} more update() passes while it ran "
        f"left it alone; its answers equal the direct ones "
        f"({daemon_launches} forward launches in the daemon); idle "
        f"{AUTOSCALE_IDLE_S} s, update() terminated it; the card's free "
        f"memory {free_before} bytes before, {free_after} after; no process "
        f"of the cluster is left")
    log(f"[times] {card}: autoscaler, from the task's submission: the daemon"
        f" registered {registered_s:.2f} s, the first answer "
        f"{answer_s:.2f} s, scaled down {down_s:.2f} s (idle timeout "
        f"{AUTOSCALE_IDLE_S} s; host clock)")
    return daemon_launches


# -- phase 25: the cluster CLI, the dashboard head, the autopilot, the doctor --


class AutopilotLM:
    """User code for phase 25 (b): phase 5's f32 model from its seed on the
    replica's card; the replica batches requests itself, so ``__call__``
    takes a list and answers each request with its logit row (numpy)."""

    def __init__(self, width, device_type):
        import os
        no_tf32()
        self.fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
        self.device = granted_device(device_type)
        self.cfg, self.params = seeded_lm(self.device, width)
        self.pid, self.sizes = os.getpid(), []

    def __call__(self, requests):
        self.sizes.append(len(requests))
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in pad_requests(requests).items()}
        with torch.inference_mode():
            rows = last_token_logits(self.cfg, self.params, batch)
        return list(rows.cpu().numpy())

    def where(self):
        """(the weights' device, this process's pid)."""
        return str(next(iter(self.params.values())).device), self.pid

    def counts(self):
        """(forward-kernel launches in this process, batch sizes so far)."""
        return self.fa.launches, list(self.sizes)


def doomed_forward(width, device_type):
    """(d) the task the GPU daemon dies with: a chaos delay on its
    ``task.execute`` holds it in flight."""
    cfg, params = seeded_lm(granted_device(device_type), width)
    _, _, requests = seeded_requests(width, 1)
    return lm_answers(cfg, params, requests)


def start_module(module, *args, env=None):
    """``python -m module args`` from the repository's root, started: (the
    process, the host clock at its start)."""
    proc = subprocess.Popen([sys.executable, "-m", module, *args],
                            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def finish_modules(*started, timeout_s=SUBPROCESS_TIMEOUT_S):
    """Wait for ``start_module`` processes that run at once: [(seconds from
    each one's start to its own exit, stdout)]. Fails unless each exits 0."""
    done = [None] * len(started)

    def wait(i):
        proc, t0 = started[i]
        out, err = proc.communicate(timeout=timeout_s)
        done[i] = (time.perf_counter() - t0, out, err)

    threads = [threading.Thread(target=wait, args=(i,))
               for i in range(len(started))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()  # raylint: allow(deadline-drop) each thread's communicate() is bounded by timeout_s
    for (proc, _), got in zip(started, done):
        assert got is not None and proc.returncode == 0, (
            proc.args[2:], proc.returncode, got and got[1][-3000:],
            got and got[2][-3000:])
    return [(seconds, out) for seconds, out, _ in done]


def finish_module(started):
    """``finish_modules`` of one process: (seconds, stdout)."""
    return finish_modules(started)[0]


def wait_for_file(path, started, timeout_s=120.0):
    """Seconds from ``started``'s start until ``path`` exists; fails if the
    process exits first or the time runs out."""
    proc, t0 = started
    while not path.exists():
        if proc.poll() is not None:
            finish_module(started)
            raise AssertionError(f"{path} never appeared")
        assert time.perf_counter() - t0 < timeout_s, path
        time.sleep(0.05)
    return time.perf_counter() - t0


def parse_status(text):
    """``scripts.cluster status``'s output: {address: total resources} of
    its alive nodes."""
    import ast
    assert re.search(r"nodes: \d+ alive / \d+ total", text), text
    return {line.split()[3]: ast.literal_eval(line.split(" total=", 1)[1])
            for line in text.splitlines()
            if " ALIVE " in line and " total=" in line}


def queue_wait_counts(head, label):
    """The raw ``serve.queue_wait`` bucket counts, their sum and bounds on
    one node of the perf federation (``None`` if it has none)."""
    from ray_tpu_torch.observability import perf
    snaps, _ = head._metric_snapshots()
    return perf.extract_perf(snaps.get(label) or []).get("serve.queue_wait")


def queue_wait_p95(now, before=None):
    """p95 of the samples in ``now`` that ``before`` had not yet seen."""
    from ray_tpu_torch.observability import perf
    counts = [int(c) for c in now["counts"]]
    sum_ms = float(now.get("sum_ms", 0.0))
    if before is not None:
        counts = [a - int(b) for a, b in zip(counts, before["counts"])]
        sum_ms -= float(before.get("sum_ms", 0.0))
    return perf.summarize(counts, sum_ms, now.get("bounds"))


def cluster_pids(markers):
    """Live processes whose command line names any of ``markers`` (a
    cluster's run dirs and address): its supervisors, state service and
    daemons, restarted ones included."""
    import os
    from ray_tpu_torch.scripts.cluster import _running
    pids = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if any(m in cmd for m in markers) and _running(int(pid)):
            pids.append(int(pid))
    return pids


def autopilot_phase(fa, device, card, width=SERVE_WIDTH, cpp=None):
    """Phase 25: a cluster started by the CLI, a driver with the dashboard
    head and the autopilot in it, phase 5's model as a batched Serve
    deployment on the GPU node, the CLI's ``top`` and the doctor against the
    live cluster and after a daemon's kill. ``cpp(rt, address, token,
    gpu_pid, gpu_node, root)``, run between (c) and (d), is phase 27.
    Returns the flash forward kernel's launches (the direct answers' here
    and the replica's, counted in the GPU daemon's process) and what
    ``cpp`` returned."""
    import os
    import signal

    import ray_tpu_torch as rt
    from ray_tpu_torch import observability, serve
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.scripts import cluster as cluster_cli

    t_phase = time.perf_counter()
    root = REPO / CLI_DIR
    shutil.rmtree(root, ignore_errors=True)
    head_dir, gpu_dir, flight = root / "head", root / "gpu", root / "flight"
    flight.mkdir(parents=True)
    _, _, requests = seeded_requests(width, N_REQUESTS)
    knob = f"serve.{AUTOPILOT_DEPLOYMENT}.linger_ms"

    cli = "ray_tpu_torch.scripts.cluster"
    head_env = dict(os.environ, RAY_TPU_FLIGHT_RECORDER_DIR=str(root / "hf"))
    gpu_env = dict(os.environ, RAY_TPU_FLIGHT_RECORDER_DIR=str(flight),
                   RAY_TPU_FLIGHT_RECORDER_SPOOL_MS="50",
                   RAY_TPU_CHAOS=f"5:task.execute[name=*doomed_forward*]@1="
                                 f"delay({DOOMED_DELAY_MS})")
    doctor = gpu_stop = None
    markers = [str(head_dir), str(gpu_dir)]
    try:
        # (a) the cluster from the CLI: a head whose processes see no card
        head_start = start_module(cli, "start", "--head", "--num-gpus=0",
                                  "--num-cpus=0", f"--run-dir={head_dir}",
                                  env=head_env)
        # The references, made here while the head boots and before the GPU
        # daemon starts: the direct forward of each request alone at its
        # bucket (phase 24's), and the one-request, unpadded dense run.
        cfg, params = seeded_lm(device, width)
        dense_cfg = dataclasses.replace(cfg, use_flash=False)
        direct, dense = [], []
        fa.launches = 0
        with torch.inference_mode():
            for r in requests:
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in pad_requests([r]).items()}
                direct.append(last_token_logits(cfg, params, batch)[0].cpu()
                              .numpy())
                tokens = torch.tensor([r], device=device)
                dense.append(transformer.apply(params, tokens, dense_cfg)
                             [0, -1].cpu().numpy())
        direct_launches = fa.launches
        assert direct_launches == width["n_layers"] * len(requests)
        del params, batch, tokens
        free_device_caches()
        free_before = torch.cuda.mem_get_info(device)[0] \
            if device.type == "cuda" else 0
        # the GPU worker joins once the head has published its address
        address_s = wait_for_file(head_dir / "address", head_start)
        address = (head_dir / "address").read_text().strip()
        markers.append(address)
        token = (head_dir / "token").read_text().strip()
        token_env = dict(os.environ, RAY_TPU_AUTH_TOKEN=token)
        gpu_start = start_module(cli, "start", f"--address={address}",
                                 "--num-gpus=1",
                                 f"--num-cpus={CLI_GPU_NODE_CPUS}",
                                 f"--run-dir={gpu_dir}",
                                 f"--token-file={head_dir / 'token'}",
                                 env=gpu_env)
        while not any(n["alive"] and n["total"].get("GPU") == 1.0
                      for n in cluster_cli.status(
                          run_dir=str(head_dir))["nodes"]):
            assert gpu_start[0].poll() in (None, 0), finish_module(gpu_start)
            assert time.perf_counter() - gpu_start[1] < 120, "no GPU node"
            time.sleep(0.05)
        registered_s = time.perf_counter() - gpu_start[1]
        head_s, _ = finish_module(head_start)
        finish_module(gpu_start)
        gpu_pid = int((gpu_dir / "daemon.pid").read_text())
        # status runs beside the driver's start; it must list both daemons
        # alive and the one GPU (the driver's own node holds none)
        status = start_module(cli, "status", f"--run-dir={head_dir}")
        config = {k: str(REPO / v) for k, v in RUNTIME_CONFIG.items()}
        w = rt.init(address=address, auth_token=token, num_cpus=1,
                    include_dashboard=True,
                    _system_config=dict(config, **AUTOPILOT_CONFIG))
        try:
            alive = parse_status(finish_module(status)[1])
            daemons = {(d / "daemon.addr").read_text().strip()
                       for d in (head_dir, gpu_dir)}
            gpus = sum(r.get("GPU", 0.0) for r in alive.values())
            assert daemons <= set(alive) and gpus == 1.0, (alive, daemons)
            head = w.dashboard_head
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{w.dashboard_port}/api/cluster",
                    timeout=60) as resp:
                nodes = json.loads(resp.read())["nodes"]
            (gpu_node,) = [n for n in nodes
                           if n["alive"] and n["total"].get("GPU") == 1.0]
            label = f"node:{gpu_node['node_id'][:8]}"
            log(f"[cli] (a) scripts.cluster start --head --num-gpus=0 "
                f"published the address in {address_s:.2f} s and returned "
                f"in {head_s:.2f} s; start --address --num-gpus=1 with the "
                f"head's token; status: both daemons alive, {gpus:.0f} GPU; a"
                f" driver init(address=, auth_token=, num_cpus=1, "
                f"include_dashboard=True) serves /api/cluster on port "
                f"{w.dashboard_port}, which lists the GPU node {label}")
            launches, rows = autopilot_serve(
                serve, head, address, device, requests, direct, dense,
                width, knob, label, gpu_pid, token_env)
            cpp_out = cpp and cpp(rt, address=address, token=token,
                                  gpu_pid=gpu_pid,
                                  gpu_node=gpu_node["node_id"], root=root)
            # (d) the doctor after a kill
            observability.enable()
            doomed = rt.remote(num_gpus=1, max_retries=0)(doomed_forward)
            with observability.span("phase25-doomed") as sp:
                trace_id = sp.trace_id
                ref = doomed.remote(width, device.type)
                deadline = time.monotonic() + 60
                while not any(trace_id.encode() in lw.read_bytes()
                              for lw in flight.glob("*/lastwords.bin")):
                    assert time.monotonic() < deadline, "never in flight"
                    time.sleep(0.05)
            os.kill(gpu_pid, signal.SIGKILL)
            t_kill = time.perf_counter()
            # the GPU node's stop starts now: its supervisor is restarting
            # the daemon meanwhile, which a later stop would wait out
            gpu_stop = start_module(cli, "stop", f"--run-dir={gpu_dir}")
            del ref
            free_after = wait_free_memory(device, free_before,
                                          timeout_s=MEMORY_BACK_S) \
                if device.type == "cuda" else 0
            back_s = time.perf_counter() - t_kill
            # the doctor reads the flight dir while the cluster goes down
            doctor = start_module("ray_tpu_torch.doctor",
                                  f"--flight-dir={flight}", "--json")
        finally:
            rt.shutdown()
    finally:
        # (e) stop both nodes; fails if any process of the cluster is left
        pids = set(cluster_pids(markers)) - {gpu_stop and gpu_stop[0].pid}
        stops = [gpu_stop] + [start_module(cli, "stop", f"--run-dir={d}")
                              for d in (gpu_dir, head_dir)[bool(gpu_stop):]
                              if (d / "supervisor.pid").exists()]
        done = finish_modules(*filter(None, [doctor] + stops))
        deadline = time.monotonic() + 15
        while cluster_pids(markers):
            assert time.monotonic() < deadline, cluster_pids(markers)
            time.sleep(0.1)
    doctor_s, text = done[0]
    report = json.loads(text)
    (crash,) = [c for c in report["crashes"] if trace_id in c["trace_ids"]]
    assert crash["role"] == "host_daemon", crash
    assert "external-kill" in crash["exit_reason"], crash
    assert crash["pid"] == gpu_pid, (crash["pid"], gpu_pid)
    assert any(t["name"].endswith("doomed_forward")
               and t["trace_id"] == trace_id
               for t in crash["inflight_tasks"]), crash
    log(f"[cli] (d) a num_gpus=1 task held in flight on the GPU daemon by a "
        f"chaos delay on task.execute, then SIGKILL of the daemon (pid "
        f"{gpu_pid}): doctor --flight-dir --json reports the crash "
        f"({crash['exit_reason']}, sealed by {crash['sealed_by']}), the "
        f"in-flight doomed_forward and its trace {trace_id}; the card's free "
        f"memory {free_before} bytes before the daemon started, {free_after} "
        f"{back_s:.2f} s after the kill")
    log(f"[cli] (e) scripts.cluster stop on the GPU node's run dir from the "
        f"kill on, shutdown(), then on the head's ("
        f"{', '.join(f'{t:.2f}' for t, _ in done[1:])} s): no process of the"
        f" cluster is left ({len(pids)} of its supervisor, state-service and"
        f" daemon processes were live when the head's stop began)")
    log(f"[times] {card}: phase 25 (host clock): the GPU node registered "
        f"{registered_s:.2f} s after scripts.cluster start; serve.run "
        f"{rows['serve_run_s']:.2f} s; the autopilot's reaction from poke() "
        f"to the retune on the replica {rows['reaction_s']:.3f} s; the "
        f"doctor's collection {rows['explain_s']:.2f} s live (--address "
        f"--explain) and {doctor_s:.2f} s from the flight dir (each a fresh "
        f"process); queue wait p95 {rows['p95_before']:.1f} ms before the "
        f"retune, {rows['p95_after']:.1f} ms after; {launches} forward "
        f"launches in the GPU daemon, {direct_launches} here for the direct "
        f"answers")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[cli] phase 25 in {time.perf_counter() - t_phase:.1f} s")
    return direct_launches + launches, cpp_out


def autopilot_serve(serve, head, address, device, requests, direct, dense,
                    width, knob, label, gpu_pid, token_env):
    """Phase 25 (b) and (c) on the live cluster: the batched deployment on
    the GPU daemon, the autopilot's retune of its linger, the doctor's
    ``--explain`` and the CLI's ``top``. Returns the forward launches in
    the GPU daemon and the phase's times."""
    from ray_tpu_torch.autopilot import APPLIED, registry

    n_layers, n = width["n_layers"], len(requests)
    lm = serve.deployment(
        AutopilotLM, name=AUTOPILOT_DEPLOYMENT, max_batch_size=8,
        batch_wait_timeout_s=AUTOPILOT_LINGER_MS / 1e3,
        pad_batch_to=BATCH_BUCKETS, target_latency_ms=SERVE_BUDGET_MS,
        ray_actor_options={"num_gpus": 1})
    t0 = time.perf_counter()
    h = serve.run(lm.bind(width, device.type))
    serve_run_s = time.perf_counter() - t0
    where, pid = h.where.remote().result(timeout=60)
    assert where.startswith(device.type) and pid == gpu_pid, (where, pid)
    # the Serve controller runs in this process (the driver's CPU), so its
    # actuators are in the registry the head's autopilot drives
    act = registry().get(knob)
    assert act is not None and act.get() == AUTOPILOT_LINGER_MS, \
        registry().names()
    assert head.autopilot is not None
    launches0, _ = h.counts.remote().result(timeout=60)

    def one_at_a_time():
        return [h.remote(r).result(timeout=300) for r in requests]

    # the replica's calls that bypass the batcher (where, counts) add
    # samples of 0 ms: each pass is read as the difference of two reads
    start = queue_wait_counts(head, label)
    answers = one_at_a_time()
    before = queue_wait_counts(head, label)
    assert sum(before["counts"]) - sum(start["counts"]) == n, (start, before)
    p95_before = queue_wait_p95(before, start)["p95_ms"]
    # what the autopilot reads: the cluster's p95 over every sample so far
    p95_seen = queue_wait_p95(before)["p95_ms"]
    ap = head.autopilot
    t0 = time.perf_counter()
    ap.poke()
    while not ap.journal.records(knob):
        assert time.perf_counter() - t0 < 60, ap.status()
        time.sleep(0.005)
    reaction_s = time.perf_counter() - t0
    (dec,) = ap.journal.records(knob)
    assert dec.action == APPLIED, dec
    assert (dec.old, dec.new) == (AUTOPILOT_LINGER_MS,
                                  AUTOPILOT_LINGER_MS / 2), dec
    assert dec.evidence["queue_wait_p95_ms"] == p95_seen, (dec, p95_seen)
    assert act.get() == AUTOPILOT_LINGER_MS / 2
    answers += one_at_a_time()
    after = queue_wait_counts(head, label)
    p95_after = queue_wait_p95(after, before)["p95_ms"]
    assert p95_after < 0.75 * p95_before, (p95_before, p95_after)
    launches, sizes = h.counts.remote().result(timeout=60)
    launches -= launches0
    assert sizes == [1] * (2 * n), sizes
    assert launches == n_layers * 2 * n, (launches, n_layers)
    for i, got in enumerate(answers):
        np.testing.assert_allclose(got, dense[i % n], rtol=1e-3, atol=1e-3)
        assert np.array_equal(got, direct[i % n]), i
    log(f"[cli] (b) autopilot_enabled: a batched deployment (f32, "
        f"max_batch_size 8, linger {AUTOPILOT_LINGER_MS:.0f} ms) on a "
        f"num_gpus=1 replica in the GPU daemon (pid {pid}, weights on "
        f"{where}) registered {knob} in the driver; {n} requests one at a "
        f"time (queue wait p95 {p95_before:.1f} ms), poke(): the journal "
        f"shows {dec.action} {dec.old} -> {dec.new} ({dec.reason}) with the "
        f"daemon's queue wait p95 {p95_seen:.1f} ms (every sample so far) as"
        f" evidence; {n} more at the new linger "
        f"(p95 {p95_after:.1f} ms); {2 * n} answers in batches of one match "
        f"the dense run at rtol=atol=1e-3 and equal the direct forward bit "
        f"for bit; {launches} forward launches in the daemon")

    # the doctor's --explain and the CLI's top run at once, read-only
    samples = sum(queue_wait_counts(head, label)["counts"])
    explain = start_module("ray_tpu_torch.doctor", f"--address={address}",
                           "--no-seal", "--explain", knob, env=token_env)
    top = start_module("ray_tpu_torch.scripts.cli", "top",
                       f"--address={address}", "--json", "--subsystem",
                       "serve", env=token_env)
    (explain_s, text), (_, top) = finish_modules(explain, top)
    assert f"ray_tpu_torch doctor --explain {knob}" in text, text
    assert f"applied: {dec.old} -> {dec.new}" in text, text
    assert f"queue_wait_p95_ms={p95_seen}" in text, text
    top = json.loads(top)
    assert top["nodes"][label]["serve.queue_wait"]["count"] == samples, top
    assert all(name.startswith("serve.") for per in top["nodes"].values()
               for name in per), top["nodes"]
    log(f"[cli] (c) doctor --address --explain {knob} printed the decision "
        f"and its evidence ({explain_s:.2f} s); scripts.cli top --json "
        f"--subsystem serve exited 0 with the daemon's serve.queue_wait row "
        f"({samples} samples, {2 * n} of them batched) and no other "
        f"subsystem")
    serve.shutdown()
    assert registry().get(knob) is None, registry().names()
    return launches, dict(serve_run_s=serve_run_s, reaction_s=reaction_s,
                          explain_s=explain_s, p95_before=p95_before,
                          p95_after=p95_after)


# -- phase 27: a C++ driver serving the flagship transformer -----------------


def start_cpp_build():
    """Phase 27's C++ program, built by ``build.build_cpp_program`` (the
    recipe of ``build_cpp_worker_demo``) in a process of its own, so that
    the script waits for it only in the phase: (the process, the host
    clock at its start). The process is killed at exit if still running."""
    import atexit
    code = ("import json, time\n"
            "from ray_tpu_torch._native import build\n"
            "t0 = time.perf_counter()\n"
            f"exe = build.build_cpp_program({str(REPO / CPP_PROGRAM)!r}, "
            f"{CPP_EXE!r})\n"
            "print('CPP_BUILD ' + json.dumps({'exe': exe, 'seconds': "
            "time.perf_counter() - t0, 'process_s': time.time() - "
            f"{time.time()!r}}}), flush=True)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, time.perf_counter()


def finish_cpp_build(started):
    """``start_cpp_build``'s result: {"exe", "seconds" (the g++ build),
    "process_s" (its process, start-up included)}."""
    _, out = finish_module(started)
    return json_line(out, "CPP_BUILD")


class ServingLM:
    """User code for phase 27, registered by name and created by the C++
    program: phase 5's f32 model from its seed on the device that
    ``resolve_device`` gives, in the process the creation task ran in; each
    answer is phase 24's (the argmax of the request's last-token logits,
    the request alone at its bucket). ``cpp_lm_class`` binds ``width`` and
    ``device_type``."""

    width = None
    device_type = None

    def __init__(self):
        import os

        import ray_tpu_torch
        from ray_tpu_torch.models import transformer
        no_tf32()
        self.fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
        device = ray_tpu_torch.resolve_device(self.device_type)
        self.cfg, self.params = seeded_lm(device, self.width)
        weight = next(iter(transformer.leaves(self.params)))
        self.where = {"pid": os.getpid(),
                      "node": ray_tpu_torch.get_runtime_context()
                      .node_id.hex(),
                      "device": str(weight.device),
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def answer(self, tokens):
        return int(lm_answers(self.cfg, self.params, [tokens])[0])

    def launches(self):
        return self.fa.launches

    def info(self):
        return json.dumps(self.where)


def cpp_lm_class(width, device_type):
    return type("ServingLM", (ServingLM,),
                {"width": width, "device_type": device_type})


def cpp_add(a, b):
    """The demo driver's named function."""
    return a + b


class Counter:
    """The demo driver's named actor class."""

    def __init__(self, start):
        self.v = start

    def add(self, x):
        self.v += x
        return self.v

    def total(self):
        return self.v


def cpp_driver_phase(rt, fa, card, build, leaf, address, token, gpu_pid,
                     gpu_node, root, width=SERVE_WIDTH, device_type="cuda"):
    """Phase 27, on phase 25's live cluster (``rt`` its driver): the C++
    program creates a ``ServingLM`` actor by name and sends phase 5's
    requests one at a time, then all at once in flight; every answer must
    equal phase 24's (``leaf["want"]``), the actor must have run on the
    card in the GPU daemon (``gpu_pid``, ``gpu_node``) with ``n_layers``
    forward launches a request counted there, the demo driver's checks must
    pass on the same cluster, and the actor must be gone after ``Kill()``.
    Returns {"launches", "seconds", ...} (the seconds include the wait
    for the build)."""
    from ray_tpu_torch._private import worker

    t_phase = time.perf_counter()
    built = finish_cpp_build(build)
    ldd = subprocess.run(["ldd", built["exe"]], capture_output=True,
                         text=True, timeout=60)
    assert ldd.returncode == 0 and "libstdc++" in ldd.stdout, ldd
    assert "protobuf" not in ldd.stdout, ldd.stdout
    _, _, requests = seeded_requests(width, N_REQUESTS)
    n_layers, n = width["n_layers"], len(requests)
    per_request = n_layers if device_type == "cuda" else 0
    rt.register_named_actor_class("ServingLM",
                                  cpp_lm_class(width, device_type))
    rt.register_named_function("cpp_add", cpp_add)
    rt.register_named_actor_class("Counter", Counter)
    req_file = root / "cpp_requests.txt"
    req_file.write_text("".join(json.dumps(r) + "\n" for r in requests))
    # phase 25's replica has left the GPU daemon: its card and CPUs are free
    deadline = time.monotonic() + 30
    while (rt.available_resources().get("GPU", 0.0)
           < rt.cluster_resources().get("GPU", 0.0)):
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.05)
    t0 = time.perf_counter()
    proc = subprocess.run([built["exe"], address, str(req_file), token],
                          capture_output=True, text=True,
                          timeout=SUBPROCESS_TIMEOUT_S)
    run_s = time.perf_counter() - t0
    assert proc.returncode == 0, (proc.returncode, proc.stdout[-3000:],
                                  proc.stderr[-3000:])
    lines = proc.stdout.splitlines()
    out = dict(ln.split("=", 1) for ln in lines if "=" in ln)
    where = json.loads(out["actor_info"])
    assert where["device"].startswith(device_type), where
    assert where["pid"] == gpu_pid and where["node"] == gpu_node, (
        where, gpu_pid, gpu_node)
    want = leaf["want"]
    for key in ("answers_one", "answers_in_flight"):
        got = [int(a) for a in out[key].split(",")]
        assert got == want, (key, got, want)
    l0, l1, l2, l3 = (int(x) for x in out["launches"].split(","))
    assert (l1 - l0, l2 - l1, l3 - l2) == (
        per_request, per_request * n, per_request * n), out["launches"]
    nodes = worker.global_worker().runtime.state.list_nodes()
    demo = {"nodes": str(len(nodes)), "kv": "from-cpp", "cpp_add(2,3)": "5",
            "typed_add": "5", "counter_add": "15", "counter_add2": "22",
            "counter_total": "22"}
    assert {k: out.get(k) for k in demo} == demo, out
    assert "typed-ok" in lines, lines
    deadline = time.monotonic() + 15
    while True:   # Kill() took effect: the actor is gone for Python too
        try:
            rt.get(rt.get_actor(out["lm_actor"]).launches.remote(),
                   timeout=5)
        except Exception:  # raylint: allow(swallow) any failure means the actor is gone (the pass condition)
            break
        assert time.monotonic() < deadline, out["lm_actor"]
        time.sleep(0.2)  # raylint: allow(bare-retry) deadline-bounded poll for the killed actor
    one_rps = n / float(out["one_s"])
    flight_rps = n / float(out["in_flight_s"])
    seconds = time.perf_counter() - t_phase
    client = leaf["client_rps"]
    log(f"[cpp] (27) {CPP_PROGRAM} built by build.build_cpp_program with "
        f"g++ alone (ldd names no libprotobuf) in a process started after "
        f"phase 2; in phase 25's cluster (token auth), "
        f"Actor(\"ServingLM\").Remote() made the actor in the GPU daemon "
        f"(pid {where['pid']}, node {where['node'][:8]}, "
        f"CUDA_VISIBLE_DEVICES={where['visible']!r}, weights on "
        f"{where['device']}); {n} requests one at a time and {n} in flight "
        f"as ObjectRef futures: every answer equals phase 24's direct "
        f"answer; forward launches in the actor's process (warm-up, one at "
        f"a time, in flight) {l1 - l0} / {l2 - l1} / {l3 - l2}; the demo's "
        f"checks on the same cluster: nodes={out['nodes']}, kv, cpp_add, "
        f"the typed Counter, Kill(); the actor gone after Kill()")
    log(f"[times] {card}: phase 27 (host clock): the C++ program's build "
        f"{built['seconds']:.2f} s (g++), its process {built['process_s']:.2f}"
        f" s; the program {run_s:.2f} s, the actor ready after "
        f"{float(out['ready_s']):.2f} s; C++ driver, f32, one request a "
        f"call: {one_rps:.2f} requests/s one at a time, {flight_rps:.2f} "
        f"with {n} in flight; phase 24: direct {leaf['direct_rps']:.2f}, Ray"
        f" Client " + " / ".join(f"{v:.2f} ({k})" for k, v in client.items())
        + f"; mean JSON bytes {float(out['request_json_bytes_mean']):.1f} a "
        f"request, {float(out['answer_json_bytes_mean']):.1f} an answer; the"
        f" phase {seconds:.1f} s")
    return {"launches": l3 - l0, "seconds": seconds,
            "build_s": built["seconds"], "one_rps": one_rps,
            "flight_rps": flight_rps}


def lockwatch_child(args_json: str) -> None:
    """Phase 26 (a), in a process of its own: phase 16's batched bf16
    deployment answers phase 5's requests from ``n_requests`` threads in
    full batches, a warm-up pass and ``LOCKWATCH_PASSES`` measured ones.
    With ``args["watch"]`` (``RAY_TPU_LOCKWATCH`` installed the watchdog,
    which writes its report at exit), one ``use_gpu`` worker then trains
    phase 8's model for ``LOCKWATCH_TRAIN_STEPS`` steps. Prints one
    ``[lockwatch-run]`` JSON line."""
    args = json.loads(args_json)
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.devtools import lockwatch
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.train import TorchTrainer

    assert lockwatch.installed() == args["watch"], lockwatch.installed()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    device = torch.device(args["device"])
    width, n_requests = args["width"], args["n_requests"]
    on_card = device.type == "cuda"
    config = {k: str(REPO / v) for k, v in RUNTIME_CONFIG.items()}
    # a request waits in full batches for the linger and the batches
    # before it; none is shed
    config["serve_queue_deadline_ms"] = LOCKWATCH_DEADLINE_MS
    out = {}
    rt.init(num_cpus=8, _system_config=config)
    try:
        _, lengths, requests, cfg32, params = serve_inputs(device, width,
                                                           n_requests)
        cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
        params16 = transformer.cast_params(params, torch.bfloat16)
        del params
        n_layers, full = cfg16.n_layers, BATCH_BUCKETS[-1]
        lm = serve.deployment(
            ServedLM, name="lm26", max_batch_size=full,
            batch_wait_timeout_s=LOCKWATCH_LINGER_S,
            pad_batch_to=BATCH_BUCKETS, target_latency_ms=SERVE_BUDGET_MS,
            ray_actor_options={"num_gpus": 1 if on_card else 0})
        h = serve.run(lm.bind(cfg16, params16, "numpy", device),
                      route_prefix=None)
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        serve_all(lambda r: h.remote(r).result(timeout=300), requests)
        seconds = []
        for _ in range(LOCKWATCH_PASSES):
            answers, s = serve_all(
                lambda r: h.remote(r).result(timeout=300), requests)
            assert all(np.isfinite(a).all() for a in answers), \
                "non-finite logits"
            seconds.append(s)
        sizes, _ = h.stats.remote().result(timeout=60)
        assert sizes == [full] * (len(sizes)), sizes
        assert len(sizes) == (1 + LOCKWATCH_PASSES) * n_requests // full, \
            sizes
        # a wrapper launches (and counts) its kernel on the card only
        assert fa.launches == on_card * n_layers * len(sizes), (
            fa.launches, sizes)
        out["batches"] = len(sizes)
        out["seconds"] = seconds
        out["rps"] = n_requests / statistics.median(seconds)
        serve.delete("lm26")

        if args["watch"]:
            flash, params, tokens = parity_inputs(
                device, args["parity_width"], tuple(args["parity_batch"]))
            trainer = TorchTrainer(
                lm_trainer_loop, train_loop_config=dict(
                    width=args["parity_width"], dtype=torch.float32,
                    device=str(device), params=params, tokens=tokens,
                    steps=LOCKWATCH_TRAIN_STEPS,
                    ckpt_every=LOCKWATCH_TRAIN_STEPS + 1, timings=[]),
                scaling_config=ScalingConfig(num_workers=1,
                                             use_gpu=on_card),
                results_timeout_s=TRAINER_TIMEOUT_S)
            before = launch_counts(fa)
            result = trainer.fit()
            assert result.error is None, result.error
            got = [(m["loss"], m["grad_norm"])
                   for m in result.metrics_history]
            np.testing.assert_allclose(
                got, args["parity"][:LOCKWATCH_TRAIN_STEPS], rtol=TRAIN_RTOL)
            n = args["parity_width"]["n_layers"]
            per_step = ((2 if flash.remat else 1) * n, n, n)
            trained = tuple(a - b for a, b in zip(launch_counts(fa), before))
            assert trained == tuple(on_card * LOCKWATCH_TRAIN_STEPS * c
                                    for c in per_step), trained
            out["train"] = got
    finally:
        serve.shutdown()
        rt.shutdown()
    out["launches"] = launch_counts(fa)
    print("[lockwatch-run] " + json.dumps(out), flush=True)


def lockwatch_run(device, watch, parity, width=SERVE_WIDTH,
                  n_requests=N_REQUESTS):
    """``lockwatch_child`` in a process of its own, with ``RAY_TPU_LOCKWATCH``
    (its report at ``LOCKWATCH_REPORT``) or without it. -> (its
    ``[lockwatch-run]`` dict, the process's seconds)."""
    import os
    args = json.dumps({"device": device.type, "width": width,
                       "n_requests": n_requests, "watch": watch,
                       "parity_width": PARITY_WIDTH,
                       "parity_batch": list(PARITY_BATCH),
                       "parity": [list(p) for p in parity]})
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_LOCKWATCH")}
    if watch:
        report = REPO / LOCKWATCH_REPORT
        report.parent.mkdir(parents=True, exist_ok=True)
        report.unlink(missing_ok=True)
        env.update(RAY_TPU_LOCKWATCH="1", RAY_TPU_LOCKWATCH_OUT=str(report))
    t0 = time.perf_counter()
    text = run_python("import chip_smoke as cs; "
                      f"cs.lockwatch_child({args!r})", env=env)
    return json_line(text, "[lockwatch-run]"), time.perf_counter() - t0


def lockwatch_ab(pairs=LOCKWATCH_AB_PAIRS):
    """The watchdog's cost on phase 26 (a)'s serving, as phase 26 cannot
    afford to measure it: ``pairs`` pairs of ``lockwatch_run`` on the card,
    with and without the watchdog, the side that runs first alternating.
    Prints each process's requests/s and each side's median and range.
    Run on the card: ``python3 -c "import chip_smoke as cs;
    cs.lockwatch_ab()"``."""
    from ray_tpu_torch.ops import _build
    _build.build()
    device = torch.device("cuda")
    log(card_line())
    parity = train_parity_phase(device)
    rates = {True: [], False: []}
    for i in range(pairs):
        for watch in ((False, True) if i % 2 == 0 else (True, False)):
            got, _ = lockwatch_run(device, watch, parity)
            rates[watch].append(got["rps"])
            log(f"[lockwatch-ab] pair {i + 1}, "
                f"{'with' if watch else 'without'} the watchdog: "
                f"{got['rps']:.2f} requests/s (pass ms "
                f"{[round(1e3 * s, 1) for s in got['seconds']]})")
    for watch, name in ((True, "with"), (False, "without")):
        r = rates[watch]
        log(f"[lockwatch-ab] {name} the watchdog: median "
            f"{statistics.median(r):.2f} requests/s, range "
            f"{min(r):.2f}-{max(r):.2f} over {pairs} processes")


def lockwatch_phase(fa, device, card, plane_rps, parity, width=SERVE_WIDTH,
                    n_requests=N_REQUESTS):
    """Phase 26 (a): ``lockwatch_child`` in a process of its own under the
    watchdog, whose report must hold no cycle and no guard violation; then
    the same child's serving part in a process without it. One pair:
    processes of the same code differ more than the two sides do, so the
    watchdog's cost is ``lockwatch_ab``'s to measure. Returns the two
    processes' (forward, dq, dkv) launches."""
    got, child_s = lockwatch_run(device, True, parity, width, n_requests)
    rep = json.loads((REPO / LOCKWATCH_REPORT).read_text())
    assert rep["wrapped_locks"] > 0, rep["wrapped_locks"]
    assert rep["cycles"] == [], rep["cycles"]
    assert rep["guard_violations"] == [], rep["guard_violations"]
    plain, plain_s = lockwatch_run(device, False, parity, width, n_requests)
    assert plain["batches"] == got["batches"], (plain, got)
    launches = tuple(a + b for a, b in zip(got["launches"],
                                           plain["launches"]))
    assert all(c > 0 for c in launches) or device.type != "cuda", launches
    passes = (f"{n_requests} bf16 requests x {LOCKWATCH_PASSES} passes "
              f"from {n_requests} threads, {got['batches']} full batches of "
              f"{BATCH_BUCKETS[-1]} with the warm-up pass")
    log(f"[lockwatch] (a) RAY_TPU_LOCKWATCH=1 process ({child_s:.1f} s): "
        f"{passes} through a num_gpus=1 batched deployment, then "
        f"{LOCKWATCH_TRAIN_STEPS} TorchTrainer steps of phase 8's model, "
        f"(loss, grad norm) {got['train']} on phase 8's at {TRAIN_RTOL}; "
        f"report: {rep['wrapped_locks']} locks wrapped, "
        f"{len(rep['edges'])} order edges, 0 cycles, 0 guard violations, "
        f"{len(rep['long_holds'])} holds over the threshold; launches "
        f"(forward, dq, dkv) {tuple(got['launches'])}")
    log(f"[lockwatch] (a) the same serving without the watchdog "
        f"({plain_s:.1f} s): {passes}; launches (forward, dq, dkv) "
        f"{tuple(plain['launches'])}")
    ms = ", ".join(f"{1e3 * w:.1f} / {1e3 * p:.1f}"
                   for w, p in zip(got["seconds"], plain["seconds"]))
    log(f"[times] {card}: bf16 serving through the Serve plane from "
        f"{n_requests} threads in full batches: {got['rps']:.2f} requests/s"
        f" under lockwatch, {plain['rps']:.2f} without it in the same code"
        f" ({got['rps'] / plain['rps']:.3f} x; medians of "
        f"{LOCKWATCH_PASSES} passes, ms with / without: {ms}); phase 16 "
        f"without it {plane_rps:.2f} requests/s (batches as they came)")
    return launches


def _band(row):
    """Elements of each band around a tensor whose rows hold ``row``
    elements: whole 64-element runs, so a bf16 view in the middle stays
    16-byte aligned."""
    pad = max(GUARD_BAND_MIN, GUARD_BAND_ROWS * row)
    return -(-pad // 64) * 64


def _banded(shape, dtype, device, fill):
    """(buffer, band, view): ``view`` of ``shape`` in the middle of
    ``buffer``, whose bands of ``band`` elements each side hold ``fill``."""
    n = math.prod(shape)
    band = _band(math.prod(shape[2:]) if len(shape) == 4 else shape[-1])
    buf = torch.full((band + n + band,), fill, dtype=dtype, device=device)
    return buf, band, buf[band:band + n].view(shape)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def guarded_launch(run, symbol, ins, outs, causal, scale, fill):
    """One kernel launch with every input copied into the middle of a
    banded buffer and every output written into one. ``run`` launches
    ``symbol`` on the tensors; ``outs`` are (shape, dtype). Returns the
    outputs (copies) and fails if a band changed."""
    device = ins[0].device
    placed, views = [], []
    for t in ins:
        buf, band, view = _banded(tuple(t.shape), t.dtype, device, fill)
        view.copy_(t)
        placed.append((buf, band))
        views.append(view)
    out_views = []
    for shape, dtype in outs:
        buf, band, view = _banded(tuple(shape), dtype, device, fill)
        placed.append((buf, band))
        out_views.append(view)
    run(symbol, views + out_views, views[0], views[1], causal, scale)
    if device.type == "cuda":
        torch.cuda.synchronize()
    for buf, band in placed:
        want = _bits(torch.full((band,), fill, dtype=buf.dtype,
                                device=device))
        bits = _bits(buf)
        assert torch.equal(bits[:band], want), f"{symbol}: band before " \
            f"a tensor changed (fill {fill})"
        assert torch.equal(bits[-band:], want), f"{symbol}: band after " \
            f"a tensor changed (fill {fill})"
    return [v.clone() for v in out_views]


def guarded_case(fa, run, q, k, v, do, causal, fill):
    """The forward, dq and dkv kernels on banded buffers filled with
    ``fill``: (O, LSE, dQ, dK, dV)."""
    fa._check_kernel_inputs(q, k, v)
    B, Lq, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    o, lse = guarded_launch(
        run, "ray_tpu_torch_flash_attention_fwd", [q, k, v],
        [(q.shape, q.dtype), ((B, H, Lq), torch.float32)], causal, scale,
        fill)
    assert torch.isfinite(o).all().item() and \
        torch.isfinite(lse).all().item(), "non-finite forward"
    delta = fa.attention_delta(o, do)
    (dq,) = guarded_launch(
        run, "ray_tpu_torch_flash_attention_dq", [q, k, v, do, lse, delta],
        [(q.shape, q.dtype)], causal, scale, fill)
    dk, dv = guarded_launch(
        run, "ray_tpu_torch_flash_attention_dkv",
        [q, k, v, do, lse, delta], [(k.shape, k.dtype), (v.shape, v.dtype)],
        causal, scale, fill)
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert torch.isfinite(t).all().item(), f"non-finite {name}"
    return o, lse, dq, dk, dv


def guard_band_phase(fa, device, run=None):
    """Phase 26 (b): every case with 0 bands and with NaN bands; outputs
    bit-identical between the two and no band changed; then a multi-head
    run against its heads run alone. ``run`` launches a kernel (the
    wrappers' ``_run_kernel``; a CPU rehearsal passes a plain stand-in).
    Returns the number of kernel launches it made."""
    run = run or fa._run_kernel
    gen = torch.Generator(device=device).manual_seed(SEED + 26)
    n_launch, n_cases = 0, 0
    names = ("O", "LSE", "dQ", "dK", "dV")
    for dt in (torch.bfloat16, torch.float32):
        for D in (16, 32, 64, 128):
            for Lq, Lk in GUARD_SHAPES:
                for causal in (True, False):
                    q, k, v = random_qkv(gen, 1, Lq, Lk, 1, D, dt, device)
                    do = torch.randn(q.shape, generator=gen,
                                     device=device).to(dt)
                    zero = guarded_case(fa, run, q, k, v, do, causal, 0.0)
                    nan = guarded_case(fa, run, q, k, v, do, causal,
                                       float("nan"))
                    case = (f"Lq={Lq} Lk={Lk} D={D} {dt} "
                            f"causal={causal}")
                    for name, a, b in zip(names, zero, nan):
                        assert torch.equal(_bits(a), _bits(b)), \
                            f"{name} depends on memory past a tensor: {case}"
                    n_launch += 6
                    n_cases += 1
    B, L, H, D = GUARD_HEADS
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = random_qkv(gen, B, L, L, H, D, dt, device)
        do = torch.randn(q.shape, generator=gen, device=device).to(dt)
        whole = guarded_case(fa, run, q, k, v, do, True, float("nan"))
        n_launch += 3
        for h in range(H):
            one = guarded_case(
                fa, run, *(t[:, :, h:h + 1].contiguous()
                           for t in (q, k, v, do)), True, float("nan"))
            n_launch += 3
            for name, a, b in zip(names, whole, one):
                part = a[:, h:h + 1] if name == "LSE" else a[:, :, h:h + 1]
                assert torch.equal(_bits(part.contiguous()), _bits(b)), \
                    f"{name} of head {h} differs run alone: {dt}"
    log(f"[guard-band] (b) {n_cases} single-head cases (bf16 and f32; D 16"
        f"/32/64/128; L {GUARD_SHAPES}; causal and full) with 0 and with "
        f"NaN bands around every input and output: O, LSE, dQ, dK and dV "
        f"bit-identical between the fills and every band unchanged; "
        f"{B} x {H} heads at L={L} D={D} equal each head run alone, bit "
        f"for bit; {n_launch} comparison launches, not counted")
    return n_launch


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. device
    t_last, laps = time.perf_counter(), []

    def lap(phase):
        """Phase ``phase`` ended: its seconds since the previous one."""
        nonlocal t_last
        now = time.perf_counter()
        laps.append((phase, now - t_last))
        t_last = now

    card = card_line()
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    lap(1)

    # 2. build
    from ray_tpu_torch.ops import _build
    t0 = time.perf_counter()
    results = _build.build()
    for r in results.values():
        log(f"[build] {r.name}: {r.seconds:.1f} s -> {r.path.name}")
        for line in ptxas_summary(r.log):
            log(f"[build]   {line}")
            if line.startswith("fwd_bf16_kernel"):
                assert "0 bytes spill stores, 0 bytes spill loads" in line, \
                    line
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")
    cpp_build = start_cpp_build()   # phase 27's program, waited for there
    lap(2)

    # 3. kernels against their plain versions
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    check_kernel(fa, device)
    lap(3)

    # 4. entry point
    from ray_tpu_torch.entry import CONFIG, entry
    fn, args = entry()
    before = fa.launches
    logits = fn(*args)
    torch.cuda.synchronize()
    assert logits.shape == (4, 512, CONFIG.vocab_size), logits.shape
    assert torch.isfinite(logits).all().item()
    assert fa.launches == before + CONFIG.n_layers
    log(f"[entry] flagship forward {tuple(logits.shape)} finite, "
        f"{CONFIG.n_layers} kernel launches")
    del fn, args, logits
    lap(4)

    # 5. the serving path (the main path; launches counted here)
    served = serve_phase(fa, device)
    seconds = served["seconds"]
    log(f"[times] {card}: bf16 serving {N_REQUESTS / seconds:.2f} requests/s,"
        f" {served['n_tokens'] / seconds:.0f} tokens/s (median of "
        f"{SERVE_RUNS} runs of {N_REQUESTS} requests, {served['n_tokens']} "
        f"real tokens each, {seconds:.4f} s); one 8 x 1024 batch forward "
        f"{served['forward_ms']:.3f} ms")
    lap(5)

    # 6. kernel times at the serving shape
    B, L, H = BATCH_BUCKETS[-1], LENGTH_BUCKETS[-1], SERVE_WIDTH["n_heads"]
    D, dt = SERVE_WIDTH["d_model"] // H, torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    q, k, v = random_qkv(gen, B, L, L, H, D, dt, device)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    ro, rlse = fa.flash_attention_reference(q, k, v, True)
    check_bf16_forward(o, lse, ro, rlse, "the serving shape")
    max_abs_err = (o.float() - ro.float()).abs().max().item()
    del o, lse, ro, rlse
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, True),
                       windows=5)
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    bound_ms, bound_by = attention_bound(B, L, L, H, D, dt, True)
    log(f"[times] {card}: flash_attention_fwd B={B} L={L} H={H} D={D} bf16 "
        f"causal: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"{served['n_layers']} launches = "
        f"{100 * served['n_layers'] * ms / served['forward_ms']:.1f}% of "
        f"the batch forward")
    del q, k, v, qt, kt, vt
    forward_cell_times(fa, device, card)
    lap(6)

    # 7. backward kernels against their plain versions
    check_backward(fa, device)
    lap(7)

    # 8. f32 training through the kernels against dense attention
    parity = train_parity_phase(device)
    lap(8)

    # 9. the training path (the kernels line's launches are counted here)
    trained = train_phase(fa, device)
    log(f"[times] {card}: bf16 training step {trained['step_ms']:.3f} ms "
        f"(median of {TRAIN_STEPS}), {trained['tokens_per_s']:.0f} tokens/s,"
        f" {trained['model_tflops']:.1f} model TFLOP/s (6 x params x tokens),"
        f" peak memory {trained['peak_bytes'] / 2**30:.2f} GiB")
    lap(9)

    # 10. backward kernel times at the training shape
    bwd = backward_times(fa, device, B, L, H, D, dt)
    n, step_ms = trained["n_layers"], trained["step_ms"]
    parts = {"forward": 2 * n * ms, "dq": n * bwd["dq_ms"],
             "dkv": n * bwd["dkv_ms"]}
    share = sum(parts.values()) / step_ms
    split = ", ".join(f"{k} {v:.3f} ms ({100 * v / step_ms:.1f}%)"
                      for k, v in parts.items())
    log(f"[times] {card}: backward B={B} L={L} H={H} D={D} bf16 causal: "
        f"dq kernel {bwd['dq_ms']:.4f} ms (bound {bwd['dq_bound'][0]:.4f} "
        f"ms, {bwd['dq_bound'][1]}), dkv kernel {bwd['dkv_ms']:.4f} ms "
        f"(bound {bwd['dkv_bound'][0]:.4f} ms, {bwd['dkv_bound'][1]}), plain"
        f" backward {bwd['plain_ms']:.4f} ms, SDPA backward "
        f"{bwd['library_ms']:.4f} ms (read again: "
        f"{bwd['library_ms_repeat']:.4f} ms); per training step {2 * n} "
        f"forward + "
        f"{n} dq + {n} dkv launches = {100 * share:.1f}% of the "
        f"{step_ms:.3f} ms step: {split}")
    lap(10)

    # 28. the one-pass AdamW kernel at the training cells' leaf sets
    free_device_caches()
    adamw_times = adamw_phase(device, card)
    lap(28)

    # 11. ResNet, card against CPU in f32 (TF32 is off above)
    resnet_parity_phase(device)
    lap(11)

    # 12. ResNet training at full width (the image path; no flash kernel)
    torch.backends.cudnn.benchmark = True   # the bench's setting
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    for name, batch in RESNET_TRAIN:
        r = resnet_train_phase(device, name, batch)
        mfu = "not known" if r["mfu_pct"] is None else f"{r['mfu_pct']:.2f}%"
        log(f"[times] {card}: {name} bf16 training step {r['step_ms']:.3f} "
            f"ms (median of {RESNET_STEPS}), {r['images_per_s']:.1f} "
            f"images/s, {r['model_tflops']:.1f} model TFLOP/s, MFU {mfu}, "
            f"peak memory {r['peak_bytes'] / 2**30:.2f} GiB")
    assert launch_counts(fa) == (0, 0, 0), launch_counts(fa)
    torch.cuda.empty_cache()    # the bench's process needs the memory
    lap(12)

    # 13. the port's bench, as a user runs it
    from ray_tpu_torch import bench
    head, lm = bench_phase()
    per_step = (2 * n, n, n)
    got = tuple(lm["launches"][k] for k in ("fwd", "dq", "dkv"))
    assert got == tuple(lm["steps_run"] * c for c in per_step), (got, lm)
    log(f"[bench] {card}: transformer section {lm['step_ms']:.3f} ms a step "
        f"(median of {lm['runs']} runs of {bench.TRANSFORMER_STEPS}), phase "
        f"9 {step_ms:.3f} ms; launches (forward, dq, dkv) {got} in "
        f"{lm['steps_run']} steps")
    log(json.dumps(head))
    lap(13)

    # 14. the sharded step: dry run on every card, then a world of one
    torch.cuda.empty_cache()
    sharded = sharded_phase(fa, device, parity, step_ms)
    paired = {k: statistics.median(v) for k, v in sharded["paired"].items()}
    log(f"[times] {card}: bf16 training step, sharded path (world size 1) "
        f"{sharded['step_ms']:.3f} ms, one-device path (phase 9) "
        f"{step_ms:.3f} ms; in turns (median of {2 * STEP_PAIRS} each): "
        f"sharded {paired['sharded']:.3f} ms, one-device "
        f"{paired['one-device']:.3f} ms")
    lap(14)

    # 15. the in-process runtime: device objects, the serving path from a
    # GPU actor (launches counted there), a GPU task
    torch.cuda.empty_cache()
    runtime = runtime_phase(fa, device, card, N_REQUESTS / seconds)
    lap(15)

    # 16. the Serve plane: controller, replicas, router, handles and the
    # HTTP proxy (launches counted in each sub-phase)
    t0 = time.perf_counter()
    plane = serve_plane_phase(fa, device, card, N_REQUESTS / seconds,
                              runtime["actor_rps"])
    log(f"[serve-plane] phase 16 in {time.perf_counter() - t0:.1f} s")
    lap(16)

    # 17. TorchTrainer: the training path from GPU train workers (launches
    # counted in each of (a)-(c))
    t0 = time.perf_counter()
    free_device_caches()
    trainer_launches, trainer_ms, trainer_adamw = trainer_phase(
        fa, device, card, step_ms, parity)
    log(f"[trainer] phase 17 in {time.perf_counter() - t0:.1f} s")
    lap(17)

    # 18. the multi-process runtime: the serving path from a GPU actor in a
    # daemon process (its launches counted in that process)
    t0 = time.perf_counter()
    free_device_caches()
    daemon_launches, daemon_rates = process_runtime_phase(fa, device, card, {
        "direct": N_REQUESTS / seconds, "actor": runtime["actor_rps"],
        "plane_threads": plane["threads"], "plane_single": plane["single"]})
    log(f"[process-runtime] phase 18 in {time.perf_counter() - t0:.1f} s")
    lap(18)

    # 19. the tensor plane: TorchTrainer training in a GPU daemon, a Serve
    # replica there from its checkpoint (launches counted in the daemon),
    # and collective groups across daemon processes
    t0 = time.perf_counter()
    free_device_caches()
    plane_launches, plane_adamw = tensor_plane_phase(
        fa, device, card, trained, trainer_ms, {
        "plane_threads": plane["threads"], "plane_single": plane["single"],
        "daemon_threads": daemon_rates[f"from {N_REQUESTS} threads"],
        "daemon_single": daemon_rates["from one thread"]})
    log(f"[plane] phase 19 in {time.perf_counter() - t0:.1f} s")
    lap(19)

    # 20. the data plane: BatchPredictor over a tabular dataset and
    # TorchTrainer(datasets=) fed through iter_device_batches (launches
    # counted in each)
    t0 = time.perf_counter()
    free_device_caches()
    data_launches = data_plane_phase(
        fa, device, card, (N_REQUESTS / seconds, served["n_tokens"] / seconds),
        trained, trainer_ms)
    log(f"[data] phase 20 in {time.perf_counter() - t0:.1f} s")
    lap(20)

    # 21. the RL path: PPO's learner on the card, directly, through tune.run
    # and fed by remote rollout workers (no flash kernel runs)
    free_device_caches()
    rl_phase(fa, device, card)
    lap(21)

    # 22. the memory models, IMPALA/APPO, DQN, SAC, TD3 and DDPG, each
    # learner on the card (no flash kernel runs), and phase 23's gates
    multi_gates = rl_slice_phase(fa, device, card)
    lap(22)

    # 23. the mesh PPO learner, DD-PPO, multi-agent PPO, QMIX, BC, MARWIL
    # and CQL, each learner on the card (no flash kernel runs; its gates
    # ran in phase 22's pool)
    free_device_caches()
    rl_multi_phase(fa, device, card, multi_gates)
    lap(23)

    # 24. the leaf libraries (workflow, Ray Client, Pool, joblib, jobs, the
    # state API) and the autoscaler, each driving phase 5's model (forward
    # launches counted in every process that ran one)
    free_device_caches()
    leaf = leaf_phase(fa, device, card, N_REQUESTS / seconds)
    lap(24)

    # 25. a cluster started by the CLI, the dashboard head with the
    # autopilot retuning a batched deployment on the GPU node, the CLI's top
    # and the doctor, live and after a daemon's kill (forward launches
    # counted here and in the GPU daemon); 27. on that cluster, before the
    # kill, a C++ program serving phase 5's model from an actor it makes in
    # the GPU daemon (forward launches counted there)
    free_device_caches()
    cli_launches, cpp = autopilot_phase(
        fa, device, card, cpp=functools.partial(
            cpp_driver_phase, fa=fa, card=card, build=cpp_build, leaf=leaf))
    lap(25)
    laps[-1] = (25, laps[-1][1] - cpp["seconds"])

    # 26. the devtools: (a) the serving and training paths under the
    # lock-order watchdog in a process of its own, then the serving path
    # in one without it (launches counted in both), (b) the kernels' guard
    # bands (comparison launches)
    t0 = time.perf_counter()
    free_device_caches()
    lockwatch_launches = lockwatch_phase(fa, device, card, plane["threads"],
                                         parity)
    counted = launch_counts(fa)
    guard_band_phase(fa, device)
    assert launch_counts(fa) == counted, "a guard-band launch was counted"
    log(f"[devtools] phase 26 in {time.perf_counter() - t0:.1f} s")
    lap(26)
    laps.append((27, cpp["seconds"]))
    log("[phases] seconds each (host clock): " + ", ".join(
        f"{p} {t:.1f}" for p, t in laps) +
        f"; {sum(t for _, t in laps):.1f} in all")

    fwd_launches, dq_launches, dkv_launches = (
        a + b + c + d + e for a, b, c, d, e in zip(
            trained["launches"], trainer_launches, plane_launches,
            data_launches, lockwatch_launches))
    fwd_launches += (daemon_launches + leaf["launches"] + cli_launches
                     + cpp["launches"])
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:45",
        "launches": fwd_launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, {
        "name": "flash_attention_dq",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:144",
        "launches": dq_launches,
        "max_abs_err": bwd["dq_err"],
        "ms": bwd["dq_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["dq_bound"][0],
        "bound_by": bwd["dq_bound"][1],
        "library_ms": bwd["library_ms"],
    }, {
        "name": "flash_attention_dkv",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:190",
        "launches": dkv_launches,
        "max_abs_err": bwd["dkv_err"],
        "ms": bwd["dkv_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["dkv_bound"][0],
        "bound_by": bwd["dkv_bound"][1],
        "library_ms": bwd["library_ms"],
    }, {
        "name": "adamw",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/adamw.cu",
        "replaces": "none (XLA fuses optax.adamw into the jitted step)",
        # the training steps of phases 9, 17 (a) and 19 (a), each checked
        # at one launch a step; phase 28's own launches left out
        "launches": (trained["adamw_launches"] + trainer_adamw
                     + plane_adamw),
        "max_abs_err": max(t["max_abs_err"] for t in adamw_times.values()),
        "ms": adamw_times["deepseek7b.train.s4k"]["ms"],
        "plain_ms": adamw_times["deepseek7b.train.s4k"]["plain_ms"],
        "bound_ms": adamw_times["deepseek7b.train.s4k"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": adamw_times["deepseek7b.train.s4k"]["library_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
