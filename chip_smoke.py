#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (no phase's exception is
caught):

0. the card's name and power limit; build the CUDA kernels from
   ray_tpu_torch/sched/csrc, ray_tpu_torch/models/csrc and
   ray_tpu_torch/rllib/csrc (five sources),
   one nvcc each, and the native object store and the dashboard's native
   client (ray_tpu_torch/_native, host C++) with one g++ each, all started
   together (build seconds printed).
1. every kernel against its plain PyTorch version on the card, with exact
   equality: K1 on the golden problem of the kernel tests, on seeded random
   problems (dead nodes, masked custom resources, over-subscribed classes)
   and on the 10k-node x 256-class stream problem; K2 and K3 applied by
   K1 in its own launch (a scan round's refresh), against the plain K2 or
   K3 then the plain K1, in both of K1's forms (40 000 nodes: the rows in
   global memory), a short last block, R = 5, negative entries, and
   indices -1, N, N + 7 dropped; timed in turns at the stream's first round
   against K1 alone and against the pair a round ran before (K2 or K3
   alone, then K1), and K1 with no pass in each mode; K1 at phase 20's
   shapes (4 and 10 nodes, C 16); K2 and K3 alone, the rows
   and delta modes of refresh_view_kernel, K2 at the bucket edges with the
   first and last node among its rows, K3 over negative entries, each
   timed alone (a round's view build, the round then writing the view in
   place) and followed by a clone (the view build before rounds worked in
   place), in turns; K4 at the bucket edges; K5 (rounds) and K6 (chunked)
   on the rounds kernels' golden
   problems, the random problems, the stream problem and K1's layout edges
   (N = 10 007, N = 40 000 with the node state in global memory, R = 5, a
   negative entry); K4 (one cooperative launch) also at its edges: out[0, 0]
   zero and not, a matrix of zeros, nonzeros only in the last block's
   range, and [256, 40 000] (its looped form), two launches bit-equal;
   torch.profiler counts the kernels a call enqueues (its launch calls,
   and the kernels' names on the card where the profiler kept every
   record; kernels_enqueued): K6 one launch of one thread-block cluster
   (its cluster size logged), K5 its zero fill and three kernels a phase
   (caps, prefix, trim), 25 at 4 rounds; any other count fails. K1, K5
   and K6 are also held against the NumPy reference (kernel_np). Median
   device times of each kernel and its plain version. Before the rest of
   phase 1, torch.profiler counts one kernel a call of K4 at the stream's
   first round, of K10a' at the train step's shapes in bf16 and f32, and
   of K10b at the forward's (the profiler loses device records, whole
   sessions once a process has gone a minute without one; PERF.md); and
   a pipelined scan round's launch and copy calls alone and after
   apply_delta or update_rows: the refresh adds its one upload and no
   launch (K1 applies it), and the round writes the view in place (no
   device-to-device copy), or this fails.
2. the 1M-task stream over 10k nodes (20% of the fleet held back, an
   autoscale flip, completions releasing resources) through
   TorchScheduler.schedule_async / fetch / apply_delta / update_rows, with
   the standing invariants asserted on every fetched round; once for each
   scheduler_kernel_algo (scan K1, rounds K5, chunked K6), each with the
   launch and copy calls of one more round after a delta printed. Under
   scan every refresh runs in K1's launch but those a later refresh
   applied before a round came (counted as they happen), or this fails;
   phases 3-5 and the GCS's scan rounds of phases 13, 18, 19 and 20 allow
   none alone.
3. a torch_cuda policy on CUDA and one on the CPU, in lockstep on
   identical 10k-node states, over synchronous and pipelined rounds;
   decisions must be equal every round and the invariant guard silent.
4. the user entry points: ray_tpu_torch.init / @remote / get with
   dependencies and an actor, scheduled through the CUDA kernel.
5. the GCS scheduling loop (cluster/gcs.py) over 10k fake nodes and 256
   task classes, for each algorithm: (a) a torch_cuda GCS on CUDA and a
   hybrid (NumPy) GCS in lockstep on one submission sequence (6 000
   tasks), placements equal task for task; (b) a pipelined torch_cuda GCS draining every task
   with nothing leaked, its rounds' launches by kernel printed; then,
   apart from that timed drain, a second such GCS whose first round and
   whose round after a release (dirty rows) are profiled, their launch
   and copy calls printed, with at least one refresh made and, under
   scan, every one in K1's launch; (c) a GCS built with the
   default config, its scheduler loop live, fed over an RPC connection as
   a driver feeds it.

6. the flagship transformer's forward (ray_tpu_torch.models, the default
   TransformerConfig in bf16, weights from a numpy seed): (a) K8 (both
   forms), K10a and K10b against their plain versions at the forward's
   shapes, in bf16 and f32 (K8 with rounded probabilities in bf16 is the
   tensor-core kernel of attention_sm90.cu, its m and l checked too and a
   second launch bit-equal; in f32 the CUDA-core one; K8's block form in
   bf16 the tensor-core kernel too, its float32 P·V as two bf16 parts of P,
   in f32 the CUDA-core one, a visible, a diagonal and a fully masked block
   each launched twice with the same bits; K10b in its rows
   form, a second launch bit-equal), with times, bounds
   and the library yardsticks (scaled_dot_product_attention, rms_norm), the
   f32 CUDA-core K8's times (both forms) beside the bf16 ones; (b) make_forward_step on
   [8, 2048] tokens, finite logits, timed; (c) the model held by an actor
   of ray_tpu_torch.init(), answering 8 requests; (d) the checks of what
   (b) and (c) gave: two sequences against the plain forward on the CPU,
   the loss at [8, 2049], both dtypes against the JAX package's golden
   (tests/data/transformer_golden.npz), each served answer equal to the
   direct call, and the ring's schedule of K8 block steps on one card
   against the whole-sequence kernel, every bf16 step a tensor-core launch.
7. the expert layer (ray_tpu_torch.models.moe, MoEConfig(): d_model 256,
   d_ff 512, 8 experts, capacity factor 1.25, bf16; weights from the MoE
   golden's numpy seed; tokens skewed toward expert 0 so that the capacity
   drops some): (a) K9a routing, K9b dispatch and K9c combine against their
   plain versions at the main path's shapes (bit-equal; gate within 1e-6),
   in bf16 and f32, K9a also where its chunks of 256 tokens meet (S 1 to
   8 192, E 1 to 64, three capacities, ties, a grid past the resident
   blocks), each launched twice with the same bits, with times (K9a's
   block count beside it), bounds and the gather alone
   (index_select) as the yardstick; (b) moe_ffn on x [8, 2048, 256] bf16,
   timed, with a dropped share above 0; (c) the layer held by an actor of
   ray_tpu_torch.init(), answering 8 requests of assorted [G, S]; (d) the
   checks: K9a on the JAX golden's logits gives JAX's routing, moe_ffn in
   both dtypes against the golden (tests/data/moe_golden.npz) over the
   groups free of near-ties, two groups against the plain moe_ffn on the
   CPU, each served answer equal to the direct call.

8. the sharded scheduler (ray_tpu_torch/sched/kernel_shard.py): (a) K7,
   K1's kernel on one thread-block cluster of p blocks, against its plain
   version, K1 and kernel_np for p = 1, 2, 4 and 8, exactly (assignments
   and availability), on the random problems of phase 1, a view with a
   negative entry, a count that ends in a block other than 0 and the
   10k-node x 256-class stream's first round; its device ms per p there,
   in turns with K1's, each p with its cluster size, threads a block and
   row form; (b) make_sharded_scheduler(8) on the card over
   bench.py's sharded_kernel_bench problem, dryrun_multichip's scheduler
   problem and the stream problem's rounds with carried availability until
   a round places nothing, every round equal to K1's; decisions a second
   of both by CUDA events.

9. training (ray_tpu_torch.parallel.tpu_train, the default
   TransformerConfig in bf16): (a) K8', K10a' and K10b' against their plain
   versions at the train step's shapes in bf16 and f32 (K8' in bf16 on the
   tensor cores, in f32 on the CUDA cores, whose time is recorded beside
   it), each launched twice with the same bits (K10a' one kernel a call,
   counted before the rest of phase 1, in both dtypes; K10b' in its rows form,
   and bit-equal to its scalar form on offset views), with times,
   bounds and the library
   yardsticks (the backward of scaled_dot_product_attention and of
   rms_norm); (b) make_train_state (seed 0) and make_train_step, 10 steps
   on one seeded [8, 2049] batch, timed, the loss finite and falling; (c)
   an actor of ray_tpu_torch.init() owning the train state from the same
   seed takes 4 steps on the batches sent to it: its losses and
   parameter checksum equal the direct run's bit for bit; (d) one step's
   loss, gradient norms, sampled gradients and post-AdamW parameters, and
   the second step's loss, in both dtypes, against the JAX package's
   golden (tests/data/train_golden.npz).

10. the expert layer's training (moe_ffn under autograd, MoEConfig() in
   bf16): (a) K9a', K9b' and K9c' against their plain versions at the main
   path's shapes in f32 and bf16, each launched twice with the same bits,
   with times, bounds and the gather alone (index_select) as the
   yardstick; (b) the layer from the main path's weights, 10 AdamW steps
   (lr 3e-4, weight decay 0.01) of the loss of
   tests/test_parallel.py::test_moe_grads_flow on x [8, 2048, 256] bf16,
   timed by CUDA events and the host clock, the loss falling, and the
   device's busy share under torch.profiler over steps 8-10 as taken by
   this script with --moe-busy-share in a process of its own that repeats
   the steps (every expert kernel of the three recorded, or it fails); (c)
   an actor of ray_tpu_torch.init()
   owning a layer from the same weights takes 4 steps: its losses and
   parameter checksum equal the direct run's bit for bit; (d) one step in
   both expert dtypes against the JAX package's golden
   (tests/data/moe_grad_golden.npz), and two groups free of near-ties on
   the card against the plain step on the CPU.

11. the paths across ranks: 4 processes spawned once on the one card, one
   gloo group over CUDA tensors (NCCL takes no two ranks on one card), the
   kernels built by this process before: K7r, the sharded scheduler's
   kernel across ranks (make_sharded_scheduler(group): terms, caps and fill
   a pass, the collectives between them), over ranks 0-1 and over all
   four, on bench.py's, dryrun_multichip's and the negative problem and the
   stream's first round carried 15 rounds, every rank's results equal to
   K1's and kernel_np's; ring attention over sp = 4 on q, k, v [8, 2048, 8,
   64] in bf16 and float32, bit-equal to ring_schedule in one process and
   within 6d's bound of whole attention; Ulysses over sp = 4 against K8's
   whole form; the expert layer over dp x ep = 1 x 4 and 2 x 2
   (MoEConfig(), x [8, 2048, 256] bf16) against the one-process layer,
   routing exactly; 4 pipeline stages of tanh(x @ w) at d 512 over 8
   microbatches [2, 2048, 512] against the stages in sequence. Then K7r
   against its plain version step by step over a 2 500-node block, and its
   steps timed. Its times are those of 4 processes sharing one card
   (ms_4_processes_on_one_H100_over_gloo), not of cards.

12. training across ranks: 4 processes spawned again on the one card, one
   gloo group over CUDA tensors, a deadline of 120 s for the phase (the
   one-process references included): (a) the dp x tp train step
   (parallel/tpu_train.py over a port mesh, the Megatron layout) at
   TransformerConfig() from numpy_params(cfg, 0) on phase 9b's tokens [8,
   2049]: 3 bf16 steps at dp x tp = 2 x 2, one float32 step there, one bf16
   step at 1 x 4; each step's loss and the parameters gathered after step 1
   against the one-process step on the same weights and tokens within
   TRAIN_GOLDEN_TOL (param over the golden's sampled positions, the share
   over every entry); every leaf's block bit-equal on every rank that holds
   it after every step; (b) the expert layer's train step of phase 10
   (MoEConfig(), x [8, 2048, 256] bf16, AdamW) through moe_ffn(mesh=...) at
   dp x ep = 2 x 2 and 1 x 4, 3 steps each, against phase 10's one-process
   step within MOE_GRAD_GOLDEN_TOL["bf16"] (losses, aux, step 1's
   gradients, the parameters after every step), the routing exact, the
   replicated leaves bit-equal; (c) on rank 0, K8 and K8' at [4, 2048, 4,
   64], K10b and K10b' at [4, 2048, 768] with 4 heads, K9a-c and K9a'-c' on
   its groups, against their plain versions. Each rank's ms a step by the
   host clock, with its collectives' ms apart, are of 4 processes sharing
   one card over gloo.

13. cluster mode (ray_tpu_torch.cluster): (a) a Cluster with two node
   daemons (4 CPUs each, the native shm store each; /dev/shm's room is
   checked first) whose GCS has the default policy, torch_cuda on the
   card, with jax_policy_min_cells 0; init(address=...), 2 000 tasks, 8
   tasks meeting at a file barrier that both nodes must reach, a 200 MB
   numpy object put and got back bit-equal, a small put/get; the GCS's
   rounds launch K1 and refresh_view (K2/K3) in this process (K4, the
   sparse download, is chosen only where a round's classes x nodes
   exceed 5 x cap, cap >= 1 024 the smallest bucket holding the round's
   tasks: a round of one class or a few, as here, would need thousands
   of nodes); (b) phase 6c's ModelServer as an actor of this
   cluster, in a worker process of its own, the full-width weights put
   into the object store and passed to its constructor: its answers to
   6c's 8 requests bit-equal to 6c's, and K8, K10a and K10b launched in
   that worker (its own counters, sent back); (c) init(cluster=True,
   num_nodes=2), one round trip, shutdown(), after which no worker process
   of the phase is alive.
14. the serving path (ray_tpu_torch.serve, ray_tpu_torch.dag) in a
   two-node Cluster of its own (the default policy on the card): node-gpu
   offers {"GPU": 1}, node-post a CPU stage's resource. (a) serve's fast
   path: ModelServer deployed with fast_path=True and ray_actor_options
   {"num_gpus": 1}, the full-width weights put into the object store and
   bound, its replica on node-gpu; 6c's 8 requests through a
   DeploymentHandle bit-equal to 6c's answers, fastpath_stats() with
   completed == submitted, no failure and no duplicate, and one request
   through the HTTP proxy (serve.run(http_port=0)), bit-equal after
   JSON; (b) a compiled graph InputNode -> ModelServer.last_logits (an
   actor asking for the GPU, on node-gpu, bound to (a)'s weights' ref
   again: the controller forwarded it into the replica, and the directory
   must still list the object) -> phase14_post (argmax and
   checksum, on node-post: the cross-node edge over rpc_dag_push /
   rpc_dag_pull), 8 execute calls equal to the eager dag.execute and to
   6c's answers; the same graph with the post stage on node-gpu, whose
   iterations differ by the edge alone; teardown() leaves no channel file
   under any daemon's chan_dir, no pinned stage worker, no capacity hold
   and no DAG; every worker reaped after shutdown. Prints the first
   answer's seconds, the 8 requests', each graph's median ms an iteration,
   the cross-node edge's (their difference) and the phase's seconds.
15. the Train library (ray_tpu_torch.train) in a Cluster of its own (the
   default policy on the card), one node offering {"GPU": 1}, at 9b's
   full width, seed and tokens: (a) JaxTrainer with one worker asking for
   the GPU, FailureConfig(max_failures=1), CheckpointConfig(num_to_keep=2):
   the loop builds make_train_state on prepare_mesh's one-rank mesh,
   reports each step's loss, checkpoints the parameters and AdamW's state
   with save_pytree after 4 steps, then raises; the restarted group loads
   the checkpoint and takes steps 5-6. Every loss bit-equal to 9b's, the
   checkpoint's checksum (and Result.checkpoint's, loaded here) equal to
   9b's after 4 steps; the store's spill of the checkpoint's tar is
   reported. (b) The first attempt's first 2 steps under profile_device in
   the fresh worker: the trace holds K8 on the tensor cores, K8', K10a' and
   K10b' (rows), the guard silent, current_accelerator_type() "H100". (c)
   JaxTrainer with two workers sharing the card (GPU 0.5 each, one gloo
   group), prepare_mesh(("dp", "tp"), (2, 1)), 3 steps: losses within
   TRAIN_GOLDEN_TOL["bf16"]["loss"] of 9b's, every leaf bit-equal across
   the ranks. No worker process alive 20 s after shutdown(). Prints each
   worker's first-step and set-up seconds, the steps' ms by the host clock,
   the checkpoint's MB, its save, report and load seconds, the restart's
   seconds and 15c's step ms a rank.
16. RLlib and Tune (ray_tpu_torch.rllib, ray_tpu_torch.tune): (a) K11
   (the runner's whole step: trunk, logits, key split, draw) against its
   plain version at B 1, 3, 64 x hidden 32, 64, 128 x A 2, 7 and over a
   512-step key chain: the next key bit for bit, the draws outside
   RL_TIE_GAP, logp within RL_LOGP_TOL; K12 (the whole PG/PPO update on
   one cluster: trunk, heads, loss head, backward, Adam) in both modes at
   batch 5, 128 and 2 048, at 7 actions, at hidden 32, and in tiles at
   hidden 128, each of 3 updates from the kernel's own state: total and vf
   within RL_CARD_TOL, pg within RL_CARD_TOL of pg_term_scale, params and
   moments within UPDATE_TOL tensor by tensor; K13 (the whole DQN update: trunks, TD head, backward,
   Adam) at batch 32 and 128, at 7 actions, and in tiles at batch 2 048 and
   at hidden 128, over 1 and 5 updates with a target sync: its stats within
   RL_CARD_TOL, params and moments within UPDATE_TOL tensor by tensor, the
   value head bit-equal; every
   kernel's two launches bit-equal; each timed at the main path's shape
   beside its plain version. (b) Algorithm at the reference's
   default width (CartPole-v1, hidden 64, 2 runners x 512 steps, batch
   2048) in a local runtime: 3 iterations each of PG and PPO with the
   learner and the runners on the card, PPO again with the runners on the
   CPU, DQN (tests/test_rllib.py:160's configuration) past learning_starts
   into its updates; each iteration's sample and update seconds by the host
   clock; AdamW.update never on the card and the policy's trunk there only
   in the DQN runners' q_values; then one runner's fragment and one update
   on the card against the CPU's (equal up to a near-tie, logp within
   RL_LOGP_TOL, total_loss within 1e-5), and a runner step's host time by
   part, a PPO update's and a DQN update's ms (scripts/profile_rllib.py).
   (c) A Tuner
   with ASHA over 4 PPO learning rates, {"CPU": 1, "GPU": 0.25} a trial,
   4 iterations at most, in a Cluster of its own: every trial reports, its
   learner launches K12 an iteration, and no worker is alive 20 s after
   shutdown().
17. Data, Workflow and the host utilities (ray_tpu_torch.data, .workflow,
   .util.queue, .util.multiprocessing) around the flagship forward and
   train step: (a) in a local runtime, tokens [64, 2048] through
   data.from_numpy(...).repartition(8).map_batches(Predictor, compute=
   ActorPoolStrategy(size=2), batch_size=8), each actor making the
   flagship's weights from the golden's seed (checksum checked): each
   row's argmax and float64 sum of the last logits bit-equal to 6b's
   forward on the same batches, sort("pred") equal to numpy's stable
   argsort and groupby("pred").count() to numpy's counts; where pyarrow or
   pandas is installed the pipeline runs again in a process where neither
   can be imported (this script with --phase17a-no-arrow), bit-equal; (b)
   in a Cluster of its own (one node offering {"GPU": 1}), tokens [64,
   2049] through from_numpy(...).random_shuffle(seed=24).repartition(1),
   lazy, passed to JaxTrainer's one worker (asking for the GPU), where the
   shuffle's exchange runs from the blocks this process put,
   through train_loop_config: 8 make_train_step steps on its
   iter_torch_batches(batch_size=8) on the card, each loss bit-equal to
   9b's step from 9b's seed on the same Dataset's iter_batches here, each
   step's wait for its batch beside its ms; (c) in a local runtime, a
   workflow step(load) -> step(forward) -> step(summarize) whose summarize
   raises while a flag file exists: run raises, resume reruns summarize
   only (the forward's launches do not move), its result equal to the
   direct forward's; (d) a Queue(maxsize=2) carrying 4 token batches from
   a producer task to this process, which runs the forward, and
   Pool(2).map running it over the same batches, both equal to the direct
   forward. Each part's seconds are printed, the phase within 150 s.
18. the autoscaler, the state API and the dashboard (ray_tpu_torch.
   autoscaler, .util.state, .dashboard, _native/native_client.cc): (a) the
   launch decision at config_5's scale (the stream fleet with its last 20 %
   held back, the first round's demand, one node type with the held-back
   rows' resources and max_workers 2 000): get_nodes_to_launch (kernel_np
   on the host) gives the launch counts, K1 on the card on the same
   hypothetical matrix gives assigned and avail bit-equal to kernel_np's
   at spread threshold 1.0, 0.0, 0.25 and 0.75, and so the same launches;
   K1 held to kernel_np at those thresholds on phase 1's problems too;
   kernel_np's host ms beside K1's; (b) the v1 Autoscaler over a Cluster
   (the GCS here, torch_cuda on the card) with a FakeNodeProvider and no
   node at the start, types cpu2 {"CPU": 2} (max 4) and gpu {"CPU": 1,
   "GPU": 1} (max 1), idle timeout 2 s: 8 one-CPU tasks, 2 num_gpus=1
   tasks each running phase 0's K1 in its worker on a problem made by a
   task (so it comes through a node's store), assigned and avail equal to
   kernel_np's, then 400 tiny tasks; (d) with the scale-down paused, the
   dashboard head and the native client over (b)'s cluster: rt_get of
   /api/nodes, /api/summary and /api/cluster_resources equal to the state
   API's, rt_call of a port function equal to the direct call,
   rt_submit_job of an entrypoint that connects by the address and runs a
   task SUCCEEDED with its log, dump_timeline with one complete event a
   finished task; then every launched node terminated within the idle
   timeout plus 15 s, no task started on a draining node, no worker alive
   20 s after shutdown(); (c) AutoscalerV2 in the same shape plus a
   STRICT_PACK group whose bundles sum to one cpu2 node (it brings that
   node up; its debits through the GCS's _flush_before_debit), every
   instance's history legal and ending TERMINATED; (e) where PyYAML
   imports, cluster_up from a YAML with a head and two workers (the head's
   GCS, in a process of its own, runs its rounds on the card: the process
   maps the scheduler library), a task's round trip, cluster_down leaving
   no process; else a line says PyYAML is absent. The topology changes
   and the pipelined windows discarded for another topology are printed,
   the invariant guard must stay silent, the phase within 90 s.
19. the analysis plane (ray_tpu_torch.analysis): (a) the GCS model checker
   at its CLI's defaults with every scheduler step a K1 round on the card,
   equal scenario by scenario to the same run on the CPU; (b) the channel
   memory model and the round-trip gates; (c) the protocol tracer and the
   race, wait-for and lock-order sanitizers around a two-node cluster whose
   GCS runs on the card; (d) the linter over the package.
20. the CLI and the scripts (ray_tpu_torch/__main__.py, ray_tpu_torch/
   scripts/), every process with RAY_TPU_jax_policy_min_cells=0 and
   RAY_TPU_jax_policy_pipeline_depth=0, so that the small clusters' rounds
   reach the card, synchronous as the NumPy twin's would be: (a) `python -m ray_tpu_torch
   start --head` with {"GPU": 1} and a worker node by `start --address`,
   then status, list nodes, summary, microbenchmark --quick (its rates
   printed), metrics, --top, --prom, stacks, a dashboard with a job's
   submit, status and logs, and stop, each exit code and key output
   checked; the head maps libcuda and adds one of nvidia-smi's compute
   apps (in a container nvidia-smi may list every app as pid 1), and its GCS's
   rounds are counted after the microbenchmark; a head that does not come up
   is run again in the foreground for its own error; (b) the serve,
   overload and gray storms' run_storm in this process at their --smoke
   settings, green on their main's gates (the overload storm's timing bars,
   RED on the card, printed, not gated), K1 launched in each; (c)
   `python -m ray_tpu_torch.scripts.lint_gate --rpc-budget`; (d) the chaos,
   GCS, data, serve and workflow soaks at short durations, each with 0
   errors (the chaos soak's invariant check clean, the GCS soak's restarts
   counted); 20c's and 20d's processes in two groups, a group's at once.
   The phase within 300 s.

Launch counters are set to 0 just before phase 2 and read after phase 5,
the model kernels' just before 6b and after 6c (every K8 launch there must
have gone to the tensor-core kernel), the expert kernels' just
before 7b and after 7c, K7's just before 8b and after it, the model
kernels' again just before 9b and after 9c, where each of the training
path's six must have launched its predicted count a step times the 14
steps, every K8 and K8' launch a tensor-core one and every K10b' launch
in the rows form, and the expert kernels' again just before 10b and after 10c, where
each of the six (K9a-c, K9a'-c') must have launched once a step over the
14 steps: every kernel of each path must have launched in its run; and
each of phase 11's ranks sets its counters to 0 before its paths and
sends them back after: K7r and K8's block form must have launched there
(the kernels line takes their launches from phase 11, 6d's ring check's
apart, as "ring_check_launches" and "ring_check_launches_tc"); each of
phase 12's ranks does the same over 12a-12b, where K8, K8', K10a, K10a',
K10b, K10b', K9a-c and K9a'-c' must each have launched on every rank (the
kernels line adds their sum over the ranks as "phase12_launches"); the
scheduler kernels' counters are set to 0 just before phase 13a and read
after it, and the model actor's worker starts at 0 and sends its own back
("phase13_launches" in the kernels line); the same for phase 14, where K1
must launch in this process (K3's launches are reported: it runs only
where the GCS's rounds overlap) and K8 (every launch on the tensor
cores), K10a and K10b in the replica's and in the stage's worker
("phase14_launches" in the kernels line, the forward's kernels summed
over the two, "phase14_launches_by_process" apart); each of phase 15's
train workers starts at 0 in its fresh process and its counters are read
through WorkerGroup.execute when its group shuts down: 15a's two workers
together must launch each of the training path's six kernels its count a
step times the 6 steps (every K8 and K8' on the tensor cores, every K10b'
in rows), and every worker of 15a and 15c each of them ("phase15_launches"
in the kernels line, "phase15_launches_by_part" apart); the RL kernels'
counters are set to 0 just before phase 16b's four runs and read after
them, where K11 must have launched once a step of the on-card runners, K12
once an update of PG and both PPO runs and K13 once a DQN update; 16c's
trial workers report their own ("phase16c_launches"); the model kernels'
counters are set to 0 just before 17a's map_batches run and read after it
(its launches 8 forwards' worth, every K8 on the tensor cores), just before
17c's run and after its resume, just before 17d and after it, each of the
three with K8, K10a and K10b launched, and 17b's train worker starts at 0
in its fresh process and sends its counters back through
WorkerGroup.execute: each of the training path's six its count a step
times 8 ("phase17_launches" in the kernels line, the parts summed,
"phase17_launches_by_part" apart); the scheduler kernels' counters are set
to 0 just before 18b and read after 18c (the GCS's process: K1 must launch
and K2 or K3 refresh the view, as in phase 13; K4 is reported,
"phase18_launches"), and each of 18b's GPU
tasks counts K1 in its worker ("phase18_gpu_task_launches"); phase 19a's
and 19c's K1-K3 ("phase19_launches") and each of phase 20b's storms'
("phase20_launches", by storm apart) go into the line too. The
JSON line before the card's name and power limit lists the kernels, K2
and K3 twice: alone ("scatter_rows", "delta_clip": refresh_view_kernel,
their launches counting either form, "launches_standalone" apart) and
applied in K1's launch ("scatter_rows_fused", "delta_clip_fused": ms is
what they add to K1's, in turns); the last line is the result.
Exits non-zero without a result when no CUDA device is present or when the
port's package is not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
R = 16
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 (non-tensor) op/s
# and bf16 dense tensor-core op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
CU_SOURCE = "ray_tpu_torch/sched/csrc/sched_kernels.cu"
MODEL_CU_SOURCE = "ray_tpu_torch/models/csrc/model_kernels.cu"
# K8 and K8' as the forward and the train step run them (bf16, rounded
# probabilities): the tensor-core kernels
SM90_CU_SOURCE = "ray_tpu_torch/models/csrc/attention_sm90.cu"
MOE_CU_SOURCE = "ray_tpu_torch/models/csrc/moe_kernels.cu"
GOLDEN_PATH = os.path.join(HERE, "tests", "data", "transformer_golden.npz")
MOE_GOLDEN_PATH = os.path.join(HERE, "tests", "data", "moe_golden.npz")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ problems


def build_stream_problem(rng, n_nodes=10_000, n_classes=256, n_tasks=1_000_000):
    """The stream cluster of bench.py's headline configuration:
    heterogeneous, CPU-bound at ~80% of one wave."""
    total = np.zeros((n_nodes, R), np.float32)
    total[:, 0] = rng.integers(128, 513, n_nodes)  # CPU
    total[:, 2] = np.where(rng.random(n_nodes) < 0.2, 8.0, 0.0)  # accelerator
    total[:, 3] = rng.integers(512, 4097, n_nodes)  # memory (GB-ish)
    alive = np.ones(n_nodes, bool)

    demands = np.zeros((n_classes, R), np.float32)
    demands[:, 0] = rng.integers(1, 5, n_classes)
    heavy = rng.random(n_classes) < 0.3
    demands[heavy, 3] = rng.integers(1, 9, heavy.sum())
    acc = rng.random(n_classes) < 0.1
    demands[acc, 2] = rng.integers(1, 3, acc.sum())
    counts = rng.multinomial(
        n_tasks, np.ones(n_classes) / n_classes
    ).astype(np.int32)
    cpu_demand = float((demands[:, 0] * counts).sum())
    total[:, 0] *= np.float32(cpu_demand / 0.8 / total[:, 0].sum())
    total[:, 0] = np.maximum(np.round(total[:, 0]), 1)
    return total, alive, demands, counts


def golden_problem():
    """The golden problem of tests/test_sched_kernel.py (seed 42)."""
    from ray_tpu_torch.sched.resources import (
        NodeResourceState, ResourceSpace, pack_demands,
    )

    rng = np.random.default_rng(42)
    N, C = 64, 7
    space = ResourceSpace()
    st = NodeResourceState(space=space)
    for i in range(N):
        st.add_node(
            f"n{i}",
            {"CPU": float(rng.integers(1, 32)),
             "memory": float(rng.integers(8, 128)),
             "TPU": float(rng.choice([0, 0, 4, 8]))},
        )
    st.available = st.available * rng.uniform(
        0.3, 1.0, size=st.available.shape).astype(np.float32)
    st.available = np.floor(st.available)
    demand_maps = []
    for _ in range(C):
        d = {"CPU": float(rng.integers(1, 4))}
        if rng.random() < 0.4:
            d["TPU"] = float(rng.integers(1, 4))
        if rng.random() < 0.5:
            d["memory"] = float(rng.integers(1, 8))
        demand_maps.append(d)
    demands = pack_demands(space, demand_maps)
    counts = rng.integers(1, 200, size=C).astype(np.int32)
    return st.available, st.total, st.alive, demands, counts


def random_problem(seed, N=2048, C=48):
    """Dead nodes, a masked custom resource, over-subscribed classes."""
    rng = np.random.default_rng(seed)
    total = np.zeros((N, R), np.float32)
    total[:, 0] = rng.integers(1, 65, N)
    total[:, 3] = rng.integers(4, 257, N)
    total[:, 5] = np.where(rng.random(N) < 0.1, rng.integers(1, 5, N), 0)
    alive = rng.random(N) > 0.1
    avail = np.floor(total * rng.uniform(0.0, 1.0, total.shape)).astype(np.float32)
    avail *= alive[:, None]
    demands = np.zeros((C, R), np.float32)
    demands[:, 0] = rng.integers(1, 9, C)
    demands[:, 3] = np.where(rng.random(C) < 0.5, rng.integers(1, 17, C), 0)
    demands[:, 5] = np.where(rng.random(C) < 0.2, 1, 0)
    counts = rng.integers(0, 4000, C).astype(np.int32)
    return avail, total, alive, demands, counts


def narrow_problem(seed, N=3000, C=24, n_res=5):
    """random_problem's kind over R = 5 columns (K1's generic column path)."""
    rng = np.random.default_rng(seed)
    total = np.zeros((N, n_res), np.float32)
    total[:, 0] = rng.integers(1, 65, N)
    total[:, 2] = rng.integers(4, 257, N)
    total[:, 4] = np.where(rng.random(N) < 0.2, rng.integers(1, 9, N), 0)
    alive = rng.random(N) > 0.05
    avail = np.floor(total * rng.uniform(0.0, 1.0, total.shape)).astype(np.float32)
    avail *= alive[:, None]
    demands = np.zeros((C, n_res), np.float32)
    demands[:, 0] = rng.integers(1, 5, C)
    demands[:, 2] = np.where(rng.random(C) < 0.5, rng.integers(1, 9, C), 0)
    demands[:, 4] = np.where(rng.random(C) < 0.2, 1, 0)
    counts = rng.integers(0, 3000, C).astype(np.int32)
    return avail, total, alive, demands, counts


def saturation_problem(N=1000):
    """Counts near 2**23 - 1 over nodes of 2**21 CPUs, so that a bucket's
    prefix passes 2**23 inside the cluster (tests/test_torch_sched_shard.py's
    problem over more nodes)."""
    total = np.zeros((N, R), np.float32)
    total[:, 0] = 2.0 ** 21
    total[:, 3] = 64.0
    alive = np.ones(N, bool)
    alive[5::97] = False
    demands = np.zeros((4, R), np.float32)
    demands[:, 0] = [1.0, 1.0, 2.0, 1.0]
    counts = np.array([2**23 - 1, 2**23 - 7, 3_000_000, 2**23 - 1], np.int32)
    return (total * alive[:, None]).astype(np.float32), total, alive, demands, counts


def stream_first_round():
    """config_5's first round: the stream fleet with its last 20 % held back
    (bench.py config_5), a tenth of each class's count."""
    total5, alive5, demands5, counts5 = build_stream_problem(np.random.default_rng(5))
    alive_s = alive5.copy()
    alive_s[int(len(alive_s) * 0.8):] = False
    first = np.floor(counts5 / 10).astype(np.int32)
    return (total5 * alive_s[:, None], total5, alive_s, demands5, first)


def k1_problems():
    """Phase 1's K1 problems before its layout edges: golden, random, and
    the stream's first round and full backlog (the first round last but one,
    as phase 1 times it)."""
    problems = [("golden", golden_problem())]
    problems += [(f"random{s}", random_problem(s)) for s in (1, 2, 3)]
    total5, alive5, demands5, counts5 = build_stream_problem(np.random.default_rng(5))
    problems.append(("stream_first_round", stream_first_round()))
    problems.append(("stream_full_backlog", (total5.copy(), total5, alive5,
                                             demands5, counts5)))
    return problems


def k1_edge_problems():
    """K1's layout edges: N not a multiple of the cluster, N past what the
    blocks' shared memory holds (the rows in global memory), R = 5 (the
    generic column path), counts near 2**23, and a view with a negative
    entry in a round that places nothing."""
    return [
        ("n10007", random_problem(11, N=10_007, C=64)),
        ("n40000_global_rows", random_problem(12, N=40_000, C=32)),
        ("r5", narrow_problem(13)),
        ("counts_near_2_23", saturation_problem()),
        ("negative", negative_problem()),
    ]


def rounds_problem(seed, N=96, C=9):
    """The problems of the rounds kernels' golden tests
    (tests/test_sched_rounds.py _random_problem)."""
    from ray_tpu_torch.sched.resources import (
        NodeResourceState, ResourceSpace, pack_demands,
    )

    rng = np.random.default_rng(seed)
    space = ResourceSpace()
    st = NodeResourceState(space=space)
    for i in range(N):
        st.add_node(
            f"n{i}",
            {"CPU": float(rng.integers(1, 32)),
             "memory": float(rng.integers(8, 128)),
             "TPU": float(rng.choice([0, 0, 4, 8]))},
        )
    st.available = np.floor(
        st.available * rng.uniform(0.3, 1.0, size=st.available.shape)
    ).astype(np.float32)
    demand_maps = []
    for _ in range(C):
        d = {"CPU": float(rng.integers(1, 4))}
        if rng.random() < 0.4:
            d["TPU"] = float(rng.integers(1, 4))
        if rng.random() < 0.5:
            d["memory"] = float(rng.integers(1, 8))
        demand_maps.append(d)
    demands = pack_demands(space, demand_maps)
    counts = rng.integers(1, 200, size=C).astype(np.int32)
    return st.available, st.total, st.alive, demands, counts


# ------------------------------------------------------------------- timing


def time_ms(torch, fn, reps=7, warm=2):
    """Median device time of fn(): the GPU is kept busy with a sleep kernel
    while the host enqueues the events and fn's launches, so the interval
    between the events is device time, not host launch overhead."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound(bytes_moved, ops, peak_ops_per_s=PEAK_F32_OPS_PER_S):
    """The least time for the work: bytes at the HBM rate or operations at
    the peak rate of their type (float32 unless given), whichever is larger."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------- phases


def phase1_kernels(torch, KT, KS, kernel_np, dev):
    """Each kernel against its plain version on the card, exact equality."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    rec = {name: {"max_abs_err": 0.0} for name in (*KT.KERNELS, *FUSED_REFRESH)}

    def err(name, a, b):
        d = float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) \
            if a.numel() else 0.0
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], d)
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: kernel != plain (max abs err {d})")

    # K1 on golden, random and stream problems
    problems = k1_problems()
    total5, first = problems[-1][1][1], problems[-2][1][4]
    for name, (avail, total, alive, demands, counts) in problems + k1_edge_problems():
        args = (T(avail), T(total), T(alive), T(demands), T(counts))
        a_k, v_k = KT.schedule_classes(*args)
        plan = KT.k1_launch_plan(*total.shape, dev)
        again = KT.schedule_classes(*args)
        if not (torch.equal(a_k, again[0]) and torch.equal(v_k, again[1])):
            raise AssertionError(f"K1 {name}: two launches gave different bits")
        passes = []
        a_p, v_p = KT._schedule_classes_plain(*args, passes_out=passes)
        err("schedule_classes", a_k, a_p)
        err("schedule_classes", v_k, v_p)
        a_n, v_n = kernel_np.schedule_classes(avail.copy(), total, alive, demands, counts)
        if not np.array_equal(a_n, a_k.cpu().numpy()):
            raise AssertionError(f"K1 {name}: kernel != kernel_np")
        if not np.array_equal(v_n, v_k.cpu().numpy()):
            raise AssertionError(f"K1 {name}: avail != kernel_np's")
        log(f"K1 {name}: N={len(total)} R={total.shape[1]} C={len(demands)} "
            f"placed={int(a_k.sum())} passes={sum(passes)}, cluster of {plan.cluster} "
            f"blocks, {plan.nodes_per_block} nodes a block, rows in "
            f"{'shared' if plan.rows_in_smem else 'global'} memory; == plain == kernel_np, "
            f"two launches bit-equal")
    # time K1 at the stream's first-round shape (the main path's shape), in
    # turns with K7 at p = 8 on the same state (K1, K7, K7, K1)
    avail, total, alive, demands, counts = problems[-2][1]
    d_pad, k_pad = KT.pad_problem(demands, counts, KT.bucket_size(len(demands)))
    args = (T(avail), T(total), T(alive), T(d_pad), T(k_pad))
    passes = []
    KT._schedule_classes_plain(*args, passes_out=passes)
    N, C = len(total), len(d_pad)
    npos = (d_pad > 0).sum(axis=1)
    # per pass and node: 3 ops per column for utilization, 11 per demanded
    # column for fit and threshold cap, ~10 for bucket, cap and fill
    ops = sum(p * N * (3 * R + 11 * int(q) + 10) for p, q in zip(passes, npos))
    bytes_k1 = 3 * N * R * 4 + N + C * R * 4 + C * 4 + C * N * 4
    thr, max_passes = KT.DEFAULT_SPREAD_THRESHOLD, KT.MAX_PASSES
    k1_run = lambda: KT.schedule_classes(*args)  # noqa: E731
    k7_run = lambda: KS._launch(*args, thr, max_passes, PATH_SHARDS)  # noqa: E731
    k1_ms = [time_ms(torch, k1_run)]
    k7_ms = [time_ms(torch, k7_run), time_ms(torch, k7_run)]
    k1_ms.append(time_ms(torch, k1_run))
    plan = KT.k1_launch_plan(N, R, dev)
    rec["schedule_classes"].update(
        ms=float(np.mean(k1_ms)),
        plain_ms=time_ms(torch, lambda: KT._schedule_classes_plain(*args), reps=3, warm=1),
        library_ms=None, bound=bound(bytes_k1, ops), ms_in_turns=k1_ms,
        k7_ms_in_turns=k7_ms, cluster=plan.cluster, passes=sum(passes),
    )
    log(f"K1 at the stream's first round [{N}, {C}]: cluster of {plan.cluster} blocks, "
        f"{plan.nodes_per_block} nodes a block, rows in "
        f"{'shared' if plan.rows_in_smem else 'global'} memory, {sum(passes)} passes; "
        f"in turns K1 {k1_ms[0]:.4f}, K7 (p = {PATH_SHARDS}) {k7_ms[0]:.4f}, "
        f"{k7_ms[1]:.4f}, K1 {k1_ms[1]:.4f} ms")
    phase1_fused_refresh(torch, KT, dev, rec, err, args, [
        (n, p) for n, p in problems + k1_edge_problems() if n in FUSED_CHECK_PROBLEMS])
    rec["schedule_classes"]["at_phase20_shapes"] = phase1_k1_small(torch, KT, dev)

    # K2 and K3 are refresh_view_kernel's rows and delta modes. K2 at the
    # row buckets' edges, N = 10k, the first and last node among the rows
    rng = np.random.default_rng(7)
    N = len(total5)
    base = T(total5)
    for n_dirty, pad in ((1, 16), (16, 16), (17, 64), (64, 64), (200, 256),
                         (1000, 1024), (4096, 4096)):
        idx = np.full(pad, N, np.int32)
        ends = [0, N - 1][:n_dirty]
        idx[:n_dirty] = rng.permutation(np.concatenate([ends, rng.choice(
            np.arange(1, N - 1), n_dirty - len(ends), replace=False)]))
        rows = rng.integers(0, 100, (pad, R)).astype(np.float32)
        ak = KT.scatter_rows_(base.clone(), T(idx), T(rows))
        ap = KT._scatter_rows_plain_(base.clone(), T(idx), T(rows))
        err("scatter_rows", ak, ap)
    # K3 on [10k, 16]: deltas of both signs, clipping at 0 and at total,
    # negative entries where the delta is 0 (clipped to 0 all the same)
    av = T(np.floor(total5 * rng.uniform(-0.2, 1, total5.shape)).astype(np.float32))
    delta_np = rng.integers(-300, 300, total5.shape).astype(np.float32)
    delta_np[rng.random(total5.shape) < 0.3] = 0.0
    delta = T(delta_np)
    tt = T(total5)
    err("delta_clip", KT.delta_clip(av, delta, tt), KT._delta_clip_plain(av, delta, tt))
    log("K2/K3 refresh_view_kernel: rows mode at pads 16..4096 with pad index N and the "
        "first and last node among the rows; delta mode [10000, 16] with negative "
        "entries: == plain")

    # time at the main path's shapes: K2 at the autoscale flip (1000 rows ->
    # pad 1024), K3 on [10k, 16]; each alone (a round's view build now: the
    # round writes the refreshed view in place) and followed by the clone
    # of the view that each round's wrapper made before, in turns (with
    # clone, alone, alone, with clone)
    idx = np.full(1024, N, np.int32)
    idx[:1000] = np.arange(8000, 9000)
    rows = total5[8000:9000]
    ti, tr = T(idx), T(np.concatenate([rows, np.zeros((24, R), np.float32)]))
    work = base.clone()

    def turns(alone):
        with_clone = lambda: alone().clone()  # noqa: E731
        a, b = [time_ms(torch, with_clone, reps=21)], [time_ms(torch, alone, reps=21)]
        b.append(time_ms(torch, alone, reps=21))
        a.append(time_ms(torch, with_clone, reps=21))
        return {"with_clone_ms": a, "alone_ms": b}

    k2_turns = turns(lambda: KT.scatter_rows_(work, ti, tr))
    k3_turns = turns(lambda: KT.delta_clip(av, delta, tt))
    # the library yardstick: index_copy_ of 1 024 distinct in-range rows (it
    # cannot drop the padding index, so every index of the same shapes is real)
    ti_lib, tr_lib = T(np.arange(8000, 9024)).long(), T(total5[8000:9024])
    rec["scatter_rows"].update(
        ms=float(np.mean(k2_turns["alone_ms"])),
        plain_ms=time_ms(torch, lambda: KT._scatter_rows_plain_(work, ti, tr), reps=21),
        library_ms=time_ms(torch, lambda: work.index_copy_(0, ti_lib, tr_lib), reps=21),
        # in place: idx read, and each of the 1 000 live rows read and
        # written (the 24 padding rows are neither read nor written)
        bound=bound(1024 * 4 + 2 * 1000 * R * 4, 0),
        view_build=k2_turns,
    )
    rec["delta_clip"].update(
        ms=float(np.mean(k3_turns["alone_ms"])),
        plain_ms=time_ms(torch, lambda: KT._delta_clip_plain(av, delta, tt), reps=21),
        library_ms=None, bound=bound(4 * total5.size * 4, 2 * total5.size),
        view_build=k3_turns,
    )
    for name, t in (("K2", k2_turns), ("K3", k3_turns)):
        log(f"view build {name} alone / with the clone, in turns: " + ", ".join(
            f"{k} {' '.join(f'{x:.4f}' for x in v)}" for k, v in t.items()))

    # K4 on the stream's first-round assignment, every cap bucket and dtype
    out = KT.schedule_classes(*args)[0][: len(demands)].contiguous()
    nnz = int((out != 0).sum())
    for cap in KT.TorchScheduler._NONZERO_BUCKETS + (nnz, max(nnz - 3, 1)):
        for dts in ((torch.int16, torch.int16, torch.uint8),
                    (torch.int32, torch.int16, torch.int32),
                    (torch.int16, torch.int32, torch.uint8),
                    (torch.int32, torch.int32, torch.int32)):
            vt = dts[2]
            src = out if vt == torch.int32 else out.clamp(max=255)
            for a, b in zip(KT.compact_nonzero(src, cap, *dts),
                            KT._compact_nonzero_plain(src, cap, *dts)):
                err("compact_nonzero", a, b)
    # the edges: out[0, 0] (the padding's value) zero and not, a matrix of
    # zeros, nonzeros only in the last block's range, and [256, 40 000]
    # (more chunks than resident blocks: the looped form)
    rng4 = np.random.default_rng(4)
    big = np.where(rng4.random((256, 40_000)) < 0.01, rng4.integers(1, 256, (256, 40_000)),
                   0).astype(np.int32)
    big[0, 0] = 9
    corner = out.clone()
    corner[0, 0] = 0 if int(out[0, 0]) else 3
    tail = torch.zeros_like(out)
    tail.view(-1)[-50:] = out.view(-1)[-50:] + 1
    edges = {"corner": (corner, nnz), "zeros": (torch.zeros_like(out), 1024),
             "last_block_only": (tail, 64), "n40000_looped": (T(big), 262_144)}
    for name, (m, cap) in edges.items():
        m = m.clamp(max=255)
        for dts in ((torch.int16, torch.int16, torch.uint8),
                    (torch.int32, torch.int32, torch.int32)):
            for a, b in zip(KT.compact_nonzero(m, cap, *dts),
                            KT._compact_nonzero_plain(m, cap, *dts)):
                err("compact_nonzero", a, b)
    blocks, per, looped = KT.k4_launch_plan(big.size, dev)
    if not looped:
        raise AssertionError("compact_nonzero [256, 40000]: not the looped form")
    # timed with the cap and dtypes the stream's first round uses
    cap = next(b for b in KT.TorchScheduler._NONZERO_BUCKETS if b >= int(first.sum()))
    vt = torch.uint8 if int(first.max()) < 256 else torch.int32
    dts = (torch.int16, torch.int16, vt)
    C_, N_ = out.shape
    plan = KT.k4_launch_plan(C_ * N_, dev)
    if plan[2]:
        raise AssertionError(f"compact_nonzero [{C_}, {N_}]: the looped form ({plan})")
    got = KT.compact_nonzero(out, cap, *dts)
    if not all(torch.equal(a, b) for a, b in zip(got, KT.compact_nonzero(out, cap, *dts))):
        raise AssertionError("compact_nonzero: two launches gave different bits")
    rec["compact_nonzero"].update(
        ms=time_ms(torch, lambda: KT.compact_nonzero(out, cap, *dts), reps=21),
        plain_ms=time_ms(torch, lambda: KT._compact_nonzero_plain(out, cap, *dts), reps=21),
        library_ms=time_ms(torch, lambda: torch.nonzero(out), reps=21),
        bound=bound(C_ * N_ * 4 + cap * (4 + (1 if vt == torch.uint8 else 4)), C_ * N_),
    )
    rec["compact_nonzero"].update(blocks=plan[0])
    log(f"K4 compact_nonzero: [{C_}, {N_}] nnz={nnz}, caps "
        f"{KT.TorchScheduler._NONZERO_BUCKETS} + edges, 4 dtype sets == plain; one "
        f"cooperative launch of {plan[0]} blocks (a chunk each, in registers), two "
        f"launches bit-equal; [256, 40000] looped: {blocks} blocks of {per} chunks; "
        f"edges {sorted(edges)} == plain")

    phase1_rounds(torch, KT, kernel_np, dev, rec, err, problems + k1_edge_problems())
    for name, r in rec.items():
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]})")
    return rec


#: K2 and K3 applied by K1 in its own launch: the kernels line's name of
#: each, its launch counter in KT.launch_counts(), and its mode
FUSED_REFRESH = {"scatter_rows_fused": "rows", "delta_clip_fused": "delta"}
#: phase 1's problems the fused refresh is held on: both of K1's forms (the
#: rows in global memory at 40 000 nodes), a short last block (10 007), R = 5
FUSED_CHECK_PROBLEMS = ("golden", "stream_first_round", "n10007", "n40000_global_rows", "r5",
                        "negative")


def refresh_operands(rng, avail, total, mode):
    """A refresh of `mode` for the view avail [N, R]: rows (1 000 dirty
    rows, or N - 2 where fewer, the first and last node among them, padded
    to their bucket with N, and -1 and N + 7 beside; some rows negative,
    kept verbatim) or a delta of both signs (clipped at 0 and at total)."""
    N, n_res = total.shape
    if mode == "rows":
        n = min(1000, N - 2)
        pad = next(b for b in (16, 64, 256, 1024, 4096) if n + 2 <= b)
        idx = np.full(pad, N, np.int32)
        idx[:n] = rng.permutation(np.concatenate([[0, N - 1], rng.choice(
            np.arange(1, N - 1), n - 2, replace=False)]))
        idx[n:n + 2] = (-1, N + 7)
        rows = rng.integers(0, 60, (pad, n_res)).astype(np.float32)
        rows[rng.random(rows.shape) < 0.02] = -1.0
        return idx, rows
    delta = rng.integers(-30, 30, (N, n_res)).astype(np.float32)
    delta[rng.random(delta.shape) < 0.3] = 0.0
    return None, delta


def phase1_fused_refresh(torch, KT, dev, rec, err, stream_args, problems):
    """K1 with K2's or K3's refresh in its own launch against its plain
    version (the plain K2 or K3, then the plain K1), exactly: on each of
    `problems` (both of K1's forms: the rows in shared memory and, at 40 000
    nodes, in global memory; a negative entry) with negative entries added
    to the view. Then, at the stream's first round (`stream_args`, 10 000 x
    16, 1 000 dirty rows of pad 1 024, or a delta [10 000, 16]), in turns:
    K1 alone (on the view, and on the view each refresh leaves, which
    changes the round's work), K1 with each refresh, and the pair a round ran
    before (K2 or K3 alone, then K1), each as a round's wrapper calls it (K1
    on a copy of the view; the pair's K2 on a copy, K3 into a new view, K1
    in place); and K1 with no pass (max_passes 0: the launch, the refresh,
    the staging of the rows, the write-back) in each mode."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    rng = np.random.default_rng(28)
    forms = set()
    for name, (avail, total, alive, demands, counts) in problems:
        N, n_res = total.shape
        if N < 3:
            continue
        view = avail.copy()
        view[rng.random(view.shape) < 0.02] = -2.0
        args = [T(x) for x in (view, total, alive, demands, counts)]
        forms.add(KT.k1_launch_plan(N, n_res, dev).rows_in_smem)
        for fused, mode in FUSED_REFRESH.items():
            idx, src = refresh_operands(rng, view, total, mode)
            ref = KT.Refresh(mode, None if idx is None else T(idx), T(src))
            a_k, v_k = KT.schedule_classes(*args, _refresh=ref)
            a_p, v_p = KT._schedule_classes_plain(*args, refresh=ref)
            err(fused, a_k, a_p)
            err(fused, v_k, v_p)
    if forms != {True, False}:
        raise AssertionError(f"fused refresh: K1's forms run {forms}, not both")
    log(f"K1 with K2's / K3's refresh in its launch: {[n for n, _ in problems]}, both forms, "
        f"negative entries, pad index N, -1 and N + 7 dropped: == plain")

    avail, total = stream_args[0], stream_args[1]
    N = avail.shape[0]
    dirty = np.arange(8000, 9000)
    idx = np.full(1024, N, np.int32)
    idx[:1000] = dirty
    rows = np.concatenate([total[8000:9000].cpu().numpy(), np.zeros((24, R), np.float32)])
    delta = T(np.random.default_rng(3).integers(-300, 300, (N, R)).astype(np.float32))
    ti, tr = T(idx), T(rows)
    refs = {"rows": KT.Refresh("rows", ti, tr), "delta": KT.Refresh("delta", None, delta)}
    rest = stream_args[1:]

    def k2_pair():
        v = avail.clone()
        KT.scatter_rows_(v, ti, tr)
        return KT.schedule_classes(v, *rest, _in_place=True)

    def k3_pair():
        return KT.schedule_classes(KT.delta_clip(avail, delta, total), *rest, _in_place=True)

    refreshed = {"rows": KT.scatter_rows_(avail.clone(), ti, tr),
                 "delta": KT.delta_clip(avail, delta, total)}
    runs = {"k1": lambda: KT.schedule_classes(*stream_args),
            "k1_on_rows_refreshed": lambda: KT.schedule_classes(refreshed["rows"], *rest),
            "k1_on_delta_refreshed": lambda: KT.schedule_classes(refreshed["delta"], *rest),
            "k1_rows": lambda: KT.schedule_classes(*stream_args, _refresh=refs["rows"]),
            "k1_delta": lambda: KT.schedule_classes(*stream_args, _refresh=refs["delta"]),
            "k2_then_k1": k2_pair, "k3_then_k1": k3_pair}
    for mode in (None, "rows", "delta"):
        runs["k1_no_pass" + (f"_{mode}" if mode else "")] = (
            lambda mode=mode: KT.schedule_classes(*stream_args, max_passes=0,
                                                  _refresh=refs.get(mode)))
    for (name, mode), pair in zip(FUSED_REFRESH.items(), ("k2_then_k1", "k3_then_k1")):
        a_f, v_f = runs[f"k1_{mode}"]()
        a_s, v_s = runs[pair]()
        err(name, a_f, a_s)
        err(name, v_f, v_s)
    turns = {k: [] for k in runs}
    for order in (list(runs), list(reversed(runs))):
        for k in order:
            turns[k].append(time_ms(torch, runs[k], reps=11))
    mean = {k: float(np.mean(v)) for k, v in turns.items()}
    for name, mode in FUSED_REFRESH.items():
        pair = "k2_then_k1" if mode == "rows" else "k3_then_k1"
        # K1's own time on the view the refresh leaves (the rows refreshed
        # are held-back nodes': no decision changes, but their utilization
        # and bucket do, and with them the sweeps' work)
        alone = f"k1_on_{mode}_refreshed"
        # the bytes the refresh adds to the round: idx and the live rows
        # read, or the delta read (K1 reads and writes the view anyway)
        added = 1024 * 4 + 1000 * R * 4 if mode == "rows" else N * R * 4
        standalone = "scatter_rows" if mode == "rows" else "delta_clip"
        plain = (lambda: KT._scatter_rows_plain_(avail.clone(), ti, tr)) if mode == "rows" \
            else (lambda: KT._delta_clip_plain(avail, delta, total))
        rec[name].update(
            ms=mean[f"k1_{mode}"] - mean[alone], plain_ms=time_ms(torch, plain, reps=21),
            library_ms=None, bound=bound(added, 0 if mode == "rows" else 2 * N * R),
            k1_ms_in_turns=turns[alone], k1_with_refresh_ms_in_turns=turns[f"k1_{mode}"],
            pair_ms_in_turns=turns[pair], pair_minus_fused_ms=mean[pair] - mean[f"k1_{mode}"],
            no_pass_ms_in_turns=turns[f"k1_no_pass_{mode}"],
            no_pass_minus_k1_no_pass_ms=mean[f"k1_no_pass_{mode}"] - mean["k1_no_pass"],
            kernel=f"schedule_classes_kernel<ROWS, 512, kRefresh{mode.title()}>",
            standalone=standalone)
    rec["schedule_classes"]["no_pass_ms_in_turns"] = turns["k1_no_pass"]
    log("K1 with the refresh in its launch at the stream's first round, in turns (ms): "
        + "; ".join(f"{k} {' '.join(f'{x:.4f}' for x in v)}" for k, v in turns.items())
        + "; added by the fused refresh: "
        + ", ".join(f"{m} {rec[n]['ms']:.4f}" for n, m in FUSED_REFRESH.items()))


def phase1_k1_small(torch, KT, dev):
    """K1 at phase 20's shapes: 4 and 10 nodes (a small cluster's GCS),
    16 classes (the bucket its rounds pad to); median device ms, its bound."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out = {}
    for N in (4, 10):
        rng = np.random.default_rng(N)
        total = np.zeros((N, R), np.float32)
        total[:, 0] = 4.0
        total[:, 3] = rng.integers(8, 33, N)
        demands = np.zeros((16, R), np.float32)
        demands[:3, 0] = (1.0, 1.0, 2.0)
        demands[:3, 3] = (0.0, 1.0, 2.0)
        demands[3:, 0] = float(KT.INF_FIT)  # the padded classes
        counts = np.zeros(16, np.int32)
        counts[:3] = (3, 2, 1)
        args = [T(x) for x in (total.copy(), total, np.ones(N, bool), demands, counts)]
        a, _ = KT.schedule_classes(*args)
        passes = []
        a_p, _ = KT._schedule_classes_plain(*args, passes_out=passes)
        if not torch.equal(a, a_p):
            raise AssertionError(f"K1 at {N} nodes != plain")
        # phase 1's count for K1 at the stream's shape, at this one
        ops = sum(p * N * (3 * R + 11 * int(q) + 10)
                  for p, q in zip(passes, (demands > 0).sum(axis=1)))
        bytes_k1 = 3 * N * R * 4 + N + 16 * R * 4 + 16 * 4 + 16 * N * 4
        ms = [time_ms(torch, lambda: KT.schedule_classes(*args), reps=21) for _ in range(2)]
        b = bound(bytes_k1, ops)
        out[f"n{N}"] = {"ms": ms, "bound_ms": b[0], "bound_by": b[1], "placed": int(a.sum()),
                        "passes": sum(passes)}
    log(f"K1 at phase 20's shapes (C 16): {json.dumps(out)}")
    return out


def phase1_rounds(torch, KT, kernel_np, dev, rec, err, k1_problems):
    """K5 and K6 against their plain versions (assignments and availability
    exact) and against kernel_np (assignments exact, availability within
    1e-3), two launches bit-equal, then at the stream's first-round shape as
    TorchScheduler calls them (padded to 256 classes, the demanded columns
    active): the kernels one call enqueues (K6 one, K5 its zero fill and six
    a round, or this fails), K6's cluster size, the device time."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    algos = (
        ("schedule_classes_rounds", KT.schedule_classes_rounds,
         KT._schedule_classes_rounds_plain, kernel_np.schedule_classes_rounds, 4, {}),
        ("schedule_classes_chunked", KT.schedule_classes_chunked,
         KT._schedule_classes_chunked_plain, kernel_np.schedule_classes_chunked, 2,
         {"chunk": 16}),
    )
    problems = [(f"rounds_golden{s}", rounds_problem(s)) for s in range(4)]
    # K1's problems but its counts near 2**23, past the rounds reference's
    # exact range (its saturated prefix places more than a count there):
    # the cluster layout's edges (N = 10 007, the node state in global
    # memory at N = 40 000, R = 5, a negative entry) among them
    problems += [(n, p) for n, p in k1_problems if n != "counts_near_2_23"]
    for name, (avail, total, alive, demands, counts) in problems:
        args = (T(avail), T(total), T(alive), T(demands), T(counts))
        # every column active, and the demanded ones as TorchScheduler passes
        # them (up to 4: the kernel's register path)
        demanded = tuple(int(i) for i in np.flatnonzero((demands > 0).any(axis=0)))
        for kname, kern, plain, ref, _, _ in algos:
            a_n, v_n = ref(avail, total, alive, demands, counts)
            for active in (None, demanded):
                a_k, v_k = kern(*args, active_idx=active)
                again = kern(*args, active_idx=active)
                if not (torch.equal(a_k, again[0]) and torch.equal(v_k, again[1])):
                    raise AssertionError(f"{kname} {name}: two launches gave different bits")
                a_p, v_p = plain(*args, active_idx=active)
                err(kname, a_k, a_p)
                err(kname, v_k, v_p)
                if not np.array_equal(a_n, a_k.cpu().numpy()):
                    raise AssertionError(f"{kname} {name}: kernel != kernel_np")
                if not np.allclose(v_n, v_k.cpu().numpy(), atol=1e-3):
                    raise AssertionError(f"{kname} {name}: avail differs from kernel_np")
        log(f"K5/K6 {name}: N={len(total)} C={len(demands)} placed "
            f"{int(a_k.sum())} (chunked) == plain == kernel_np")
    avail, total, alive, demands, counts = next(
        p for n, p in k1_problems if n == "stream_first_round")
    d_pad, k_pad = KT.pad_problem(demands, counts, KT.bucket_size(len(demands)))
    active = tuple(int(i) for i in np.flatnonzero((d_pad > 0).any(axis=0)))
    args = (T(avail), T(total), T(alive), T(d_pad), T(k_pad))
    N, C = len(total), len(d_pad)
    A = len(active)
    # each input read once, each output written once
    bytes_rounds = 3 * N * R * 4 + N + C * R * 4 + C * 4 + C * N * 4
    for kname, kern, plain, _, rounds, kw in algos:
        kw = {**kw, "rounds": rounds, "active_idx": active}
        chunk = kw.get("chunk", C)
        # per round and (class, node) cell of a class with tasks left at
        # the round's start (a finished class needs no work): fit and
        # threshold cap in phase A (9 per active column), fit in phase B
        # (4 per column), the class-priority trim in both phases (9 per
        # column), ~8 per cell per phase for the cap, prefix fill and clip
        live = rounds_live_classes(kernel_np, avail, total, alive, d_pad, k_pad, rounds,
                                   chunk)
        ops = live * N * (9 * A + 4 * A + 2 * 9 * A + 2 * 8)
        enq = kernels_enqueued(torch, lambda: kern(*args, **kw))
        rec[kname].update(
            ms=time_ms(torch, lambda: kern(*args, **kw)),
            plain_ms=time_ms(torch, lambda: plain(*args, **kw), reps=3, warm=1),
            library_ms=None, bound=bound(bytes_rounds, ops), kernels_a_call=enq.launches,
            live_class_rounds=live,
        )
        if kname == "schedule_classes_rounds":
            # K5: the zero fill of the result, then caps, prefix and trim in
            # each of a round's two phases
            phases = [n for n in enq.names if any(
                k in n for k in ("rounds_caps", "rounds_prefix", "rounds_trim"))]
            if enq.launches != 6 * rounds + 1 or (enq.complete and len(phases) != 6 * rounds):
                raise AssertionError(f"{kname}: one call enqueued {enq.launches} kernels "
                                     f"({sorted(set(enq.names))}), not the zero fill and "
                                     f"{6 * rounds}")
            log(f"{kname} at the stream's first round [{N}, {C}], A = {A}: "
                f"{enq.launches} kernels a call (the zero fill, then caps, prefix, trim "
                f"twice a round; {len(phases)} of the {6 * rounds} recorded by name on the "
                f"card); {rec[kname]['ms']:.4f} ms; {live} class-rounds with tasks left")
            continue
        if enq.launches != 1 or len(enq.names) > 1:
            raise AssertionError(f"{kname}: one call enqueued {enq.launches} kernels "
                                 f"({sorted(set(enq.names))}), not one")
        plan = KT.rounds_launch_plan(N, R, A, C, chunk, dev)
        rec[kname].update(cluster=plan.cluster, rows_in_smem=plan.rows_in_smem)
        log(f"{kname} at the stream's first round [{N}, {C}], A = {A}: one kernel a call "
            f"({_kernel_name(enq)}), a cluster of {plan.cluster} blocks, "
            f"{plan.nodes_per_block} nodes a block, node state in "
            f"{'shared' if plan.rows_in_smem else 'global'} memory; "
            f"{rec[kname]['ms']:.4f} ms; {live} class-rounds with tasks left")


def rounds_live_classes(kernel_np, avail, total, alive, demands, counts, rounds, chunk):
    """The classes with tasks left at the start of each round, summed over
    the rounds (and K6's chunks), from kernel_np run a round at a time."""
    live = 0
    avail = avail.copy()
    for s in range(0, len(counts), chunk):
        d, k = demands[s:s + chunk], counts[s:s + chunk]
        for r in range(rounds):
            placed = (kernel_np.schedule_classes_rounds(avail, total, alive, d, k,
                                                        rounds=r)[0].sum(axis=1)
                      if r else 0)
            live += int((k - placed > 0).sum())
        avail = kernel_np.schedule_classes_rounds(avail, total, alive, d, k, rounds=rounds)[1]
    return live


#: the CUDA API calls that each enqueue one kernel (cuda*: the runtime's)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel")
#: the calls that each enqueue one copy (host to device, device to device,
#: device to host)
COPY_CALLS = ("cudaMemcpy",)


class Enqueued(NamedTuple):
    launches: int     # launch calls one call made (the runtime's records)
    names: list       # the kernels the profiler recorded on the card
    complete: bool    # a recorded kernel for every launch call
    copies: int = 0   # copy calls one call made
    dtod: int = 0     # device-to-device copies the profiler recorded on the card


def kernels_enqueued(torch, fn, sessions=3, warm=True):
    """What one call of fn enqueues on the card, under torch.profiler after
    a warm call (`warm`): its launch calls (the runtime's records, on the
    host's clock) and the names of the kernels recorded on the card (copies
    and fills by the runtime left out). The profiler loses device records,
    never launch calls (PERF.md: whole sessions once a process has gone a
    minute without one; 4 of K5's 25 kernels, in each of three sessions),
    so up to `sessions` sessions are taken until one records a kernel for
    every launch call; where none does, the names are the longest
    record's and `complete` is False. Without a warm call, a call that
    launches nothing is recorded as such; after one, it fails."""
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    if warm:
        fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        calls = sum(1 for ev in events
                    if ev.device_type == cpu and ev.name.startswith(LAUNCH_CALLS))
        copies = sum(1 for ev in events
                     if ev.device_type == cpu and ev.name.startswith(COPY_CALLS))
        dtod = sum(1 for ev in events if ev.device_type == cuda and "DtoD" in ev.name)
        names = [ev.name for ev in events if ev.device_type == cuda
                 and not ev.name.startswith(("Memcpy", "Memset"))]
        if best is None or len(names) > len(best.names):
            best = Enqueued(calls, names, len(names) == calls, copies, dtod)
        if best.complete:
            break
    if best.launches == 0 and warm:
        raise RuntimeError(f"torch.profiler recorded no launch call in {sessions} sessions")
    return best


def _kernel_name(enq) -> str:
    return f"{enq.names[0][:60]}..." if enq.names else \
        "its device record lost by the profiler in every session"


def phase1_kernels_a_call(torch, KT, MK, dev, rows=16384, D=512):
    """The kernels one call enqueues, by torch.profiler (one, or this
    fails): K4 at the stream's first round as TorchScheduler calls it, K10a'
    at the train step's shapes (phase 9a's, rows 16 384 x 512) in bf16 and
    f32, and K10b at the forward's [8, 2048, 1536] bf16. Run first, right
    after the build: torch.profiler loses device records once a process
    has gone a minute without a session, as it does across phases 2-5
    (PERF.md), and once lost them here after phase 1's minute and a half."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    avail, total, alive, demands, counts = stream_first_round()
    d, k = KT.pad_problem(demands, counts, KT.bucket_size(len(demands)))
    out = KT.schedule_classes(T(avail), T(total), T(alive), T(d), T(k))[0][: len(demands)]
    cap = next(b for b in KT.TorchScheduler._NONZERO_BUCKETS if b >= int(counts.sum()))
    vt = torch.uint8 if int(counts.max()) < 256 else torch.int32
    g = torch.Generator().manual_seed(9)
    calls = {"compact_nonzero": lambda: KT.compact_nonzero(out, cap, torch.int16,
                                                           torch.int16, vt)}
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        x = (torch.randn((rows, D), generator=g) * 3.0).to(dev, dt)
        dy = torch.randn((rows, D), generator=g).to(dev, dt)
        sc = torch.randn((D,), generator=g).to(dev)
        calls[f"rmsnorm_bwd {name}"] = lambda x=x, sc=sc, dy=dy: MK.rmsnorm_bwd(x, sc, dy)
    qkv = torch.randn((8, 2048, 3 * D), generator=g).to(dev, torch.bfloat16)
    calls["rope_split"] = lambda: MK.rope_split(qkv, 8, 1e4)
    res = {}
    for what, fn in calls.items():
        enq = kernels_enqueued(torch, fn)
        if enq.launches != 1 or len(enq.names) > 1:
            raise AssertionError(f"{what}: one call enqueued {enq.launches} kernels "
                                 f"({sorted(set(enq.names))}), not one")
        name, _, dt = what.partition(" ")
        res.setdefault(name, {})["kernels_a_call" + (f"_{dt}" if dt else "")] = 1
        log(f"{what}: one kernel a call ({_kernel_name(enq)})")
    res["view_build"] = round_refresh_enqueued(torch, KT, dev)
    return res


def round_refresh_enqueued(torch, KT, dev):
    """What a pipelined scan round enqueues (schedule_async and fetch at the
    stream's first round), alone and after a refresh: apply_delta ([10 000,
    16]) or update_rows (1 000 rows, the autoscale flip). The round writes
    the view in place: no device-to-device copy is recorded and the view
    is the same tensor after it; a refresh adds its upload (one copy, idx
    and rows in one buffer) and no launch (K1 applies it in its own).
    Anything else fails."""
    avail, total, alive, demands, counts = stream_first_round()
    sched = KT.TorchScheduler(total, alive, device=dev)
    sched.set_available(avail)
    delta = np.zeros_like(total)
    idx = np.arange(8000, 9000)
    rnd = lambda: sched.fetch(sched.schedule_async(demands, counts))  # noqa: E731
    view = sched.avail
    rnd()
    if sched.avail is not view:
        raise AssertionError("a pipelined round replaced the view instead of writing it")
    res = {}
    for what, refresh, uploads in (
            ("round", lambda: None, 0),
            ("apply_delta + round", lambda: sched.apply_delta(delta), 1),
            ("update_rows + round", lambda: sched.update_rows(idx, total[idx]), 1)):
        enq = kernels_enqueued(torch, lambda: (refresh(), rnd()))
        res[what] = {"launches": enq.launches, "copies": enq.copies, "dtod": enq.dtod,
                     "kernels": sorted(set(n[:60] for n in enq.names))}
        base = res["round"]
        if enq.dtod or (enq.launches, enq.copies) != (
                base["launches"], base["copies"] + uploads):
            raise AssertionError(f"{what}: {enq.launches} launches, {enq.copies} copies "
                                 f"({enq.dtod} device to device); the round alone {base}, "
                                 f"the refresh's upload {uploads} and no launch")
        log(f"{what}: {enq.launches} kernel launches, {enq.copies} copies a call, "
            f"{enq.dtod} device to device")
    return res


def refresh_forms(before, after):
    """K2's and K3's launches between two KT.launch_counts() readings, by
    form: {"rows": {"fused": n, "standalone": n}, "delta": {...}}."""
    d = {k: after[k] - before.get(k, 0) for k in after}
    return {mode: {"fused": d[fused],
                   "standalone": d["scatter_rows" if mode == "rows" else "delta_clip"] - d[fused]}
            for fused, mode in FUSED_REFRESH.items()}


def require_fused(forms, what, allowed=None):
    """Fail unless every refresh of a scan path ran in K1's launch: none
    alone, but for `allowed` (by mode: refreshes a later refresh applied
    before any round came)."""
    allowed = allowed or {}
    extra = {m: f["standalone"] - allowed.get(m, 0) for m, f in forms.items()}
    if any(extra.values()):
        raise AssertionError(f"{what}: refreshes ran alone on the scan path, not in K1's "
                             f"launch: {forms} (allowed alone {allowed})")


def phase2_stream(torch, KT, dev, n_nodes=10_000, n_tasks=1_000_000, algo="scan"):
    """The 1M-task stream through TorchScheduler (bench.py's headline). The
    scheduler kernels' launches over it are returned (K2 and K3 by form),
    with the refreshes a later refresh applied before a round came (the
    only ones a scan round does not apply in K1's launch); then one
    profiled round after a delta, its launch and copy calls."""
    before = KT.launch_counts()
    rng = np.random.default_rng(5)
    total, alive, demands, counts = build_stream_problem(
        rng, n_nodes=n_nodes, n_tasks=n_tasks)
    n_nodes = total.shape[0]
    alive = np.ones(n_nodes, bool)
    alive[int(n_nodes * 0.8):] = False
    sched = KT.TorchScheduler(total, alive, device=dev)
    sched.set_available(total * alive[:, None])
    host_avail = (total * alive[:, None]).astype(np.float32)
    chunks = 10
    arrivals = [np.floor(counts / chunks).astype(np.int32)] * (chunks - 1)
    arrivals.append((counts - np.sum(arrivals, axis=0)).astype(np.int32))
    backlog = np.zeros_like(counts)
    inflight = []  # (complete_round, assigned)
    pipe_depth = 6
    pipe = []  # (handle, submitted)
    inflight_counts = np.zeros_like(backlog)
    round_times = []
    st = {"decisions": 0, "rnd": 0, "host_avail": host_avail,
          "backlog": backlog, "inflight_counts": inflight_counts,
          "pending": None, "superseded": {"rows": 0, "delta": 0}}
    scaled_up_at = None

    def refreshed(mode):  # a refresh waits for the next round, or a later refresh
        if st["pending"]:
            st["superseded"][st["pending"]] += 1
        st["pending"] = mode

    def fetch_oldest():
        handle, submitted = pipe.pop(0)
        assigned = sched.fetch(handle)
        placed_c = assigned.sum(axis=1).astype(np.int32)
        assert (placed_c <= submitted).all(), "stream overplaced a class"
        used_round = assigned.astype(np.float32).T @ demands
        assert (used_round <= st["host_avail"] + 1e-2).all(), "stream exceeded capacity"
        st["host_avail"] = np.maximum(st["host_avail"] - used_round, 0.0)
        st["backlog"] = st["backlog"] - placed_c
        st["inflight_counts"] = st["inflight_counts"] - submitted
        st["decisions"] += int(placed_c.sum())
        if placed_c.sum() > 0:
            inflight.append((st["rnd"] + 2, assigned))

    sync(torch, dev)
    t0 = time.perf_counter()
    while st["rnd"] < len(arrivals) or st["backlog"].sum() > 0 or inflight or pipe:
        rnd = st["rnd"]
        t_round0 = time.perf_counter()
        due = [a for r0, a in inflight if r0 <= rnd]
        inflight[:] = [(r0, a) for r0, a in inflight if r0 > rnd]
        if due:
            release = np.zeros_like(total)
            for a in due:
                release += a.astype(np.float32).T @ demands
            sched.apply_delta(release)
            refreshed("delta")
            st["host_avail"] = np.minimum(st["host_avail"] + release, total)
        if rnd < len(arrivals):
            st["backlog"] = st["backlog"] + arrivals[rnd]
        if st["backlog"].sum() > 0.15 * n_tasks and not alive.all():
            first_down = int(np.argmin(alive))
            up = slice(first_down, min(first_down + n_nodes // 10, n_nodes))
            alive[up] = True
            sched.alive = torch.from_numpy(alive.copy()).to(sched.device)
            idx = list(range(up.start, up.stop))
            sched.update_rows(idx, total[idx])
            refreshed("rows")
            st["host_avail"][idx] = total[idx]
            scaled_up_at = rnd
        submit = np.maximum(st["backlog"] - st["inflight_counts"], 0).astype(np.int32)
        did_work = False
        if submit.sum() > 0:
            pipe.append((sched.schedule_async(demands, submit, algo=algo), submit))
            st["pending"] = None
            st["inflight_counts"] = st["inflight_counts"] + submit
            did_work = True
        if pipe and (len(pipe) > pipe_depth or submit.sum() == 0):
            fetch_oldest()
            did_work = True
        if did_work:
            round_times.append(time.perf_counter() - t_round0)
        st["rnd"] += 1
        if st["rnd"] > 250:
            break
    sync(torch, dev)
    t_stream = time.perf_counter() - t0
    placed = st["decisions"]
    assert placed == int(counts.sum()), (placed, int(counts.sum()))
    assert np.isfinite(st["host_avail"]).all()
    # what a round launches: one more after a delta, under torch.profiler
    zero = np.zeros_like(total)

    def profiled_round():
        sched.apply_delta(zero)
        refreshed("delta")
        sched.fetch(sched.schedule_async(demands, arrivals[0], algo=algo))
        st["pending"] = None

    enq = kernels_enqueued(torch, profiled_round)
    forms = refresh_forms(before, KT.launch_counts())
    res = {
        "algo": algo,
        "rounds": len(round_times),
        "round_ms_median": float(np.median(round_times)) * 1e3,
        "decisions": placed,
        "decisions_per_sec": placed / t_stream,
        "stream_s": t_stream,
        "autoscaled_at_round": scaled_up_at,
        "loop_rounds": st["rnd"],
        "refreshes": forms,
        "refreshes_applied_by_a_later_refresh": st["superseded"],
        "round_after_a_delta": {"launches": enq.launches, "copies": enq.copies,
                                "kernels": sorted(set(n[:60] for n in enq.names))},
    }
    log(f"phase 2 stream: {json.dumps(res)}")
    if algo == "scan":
        require_fused(forms, "phase 2 (scan)", allowed=st["superseded"])
    return res


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lockstep_state(n_nodes, seed):
    from ray_tpu_torch.sched.resources import NodeResourceState, ResourceSpace

    rng = np.random.default_rng(seed)
    total = np.zeros((n_nodes, R), np.float32)
    total[:, 0] = rng.integers(8, 65, n_nodes)
    total[:, 3] = rng.integers(32, 257, n_nodes)
    ids = [f"n{i}" for i in range(n_nodes)]
    st = NodeResourceState(
        space=ResourceSpace(), node_ids=ids, total=total.copy(),
        available=total.copy(), alive=np.ones(n_nodes, bool),
        draining=np.zeros(n_nodes, bool), labels=[{} for _ in ids],
    )
    return st


def phase3_policy_lockstep(torch, policy_mod, Config, n=10_000, gpu="cuda"):
    """CUDA and CPU torch_cuda policies on identical 10k-node states."""
    base = {"scheduling_policy": "torch_cuda", "jax_policy_min_cells": 0,
            "jax_policy_pipeline_depth": 2}
    pol_gpu = policy_mod.make_policy_from_config(Config({**base, "scheduler_device": gpu}))
    pol_cpu = policy_mod.make_policy_from_config(Config({**base, "scheduler_device": "cpu"}))
    assert pol_gpu.device.type == gpu and pol_cpu.device.type == "cpu"
    st_g, st_c = _lockstep_state(n, 11), _lockstep_state(n, 11)
    rng = np.random.default_rng(12)
    C = 24
    demands = np.zeros((C, R), np.float32)
    demands[:, 0] = rng.integers(1, 5, C)
    demands[:, 3] = np.where(rng.random(C) < 0.4, rng.integers(1, 9, C), 0)
    running_g, running_c = [], []

    def release_some(k):
        for _ in range(min(k, len(running_g))):
            j = int(rng.integers(0, len(running_g)))
            (ng, dg), (nc, dc) = running_g.pop(j), running_c.pop(j)
            st_g.release(ng, dg)
            st_c.release(nc, dc)

    def record(plan_g, plan_c, rnd):
        tags_g, dem_g, a_g = plan_g
        tags_c, dem_c, a_c = plan_c
        assert list(tags_g) == list(tags_c), f"round {rnd}: tags differ"
        if not np.array_equal(a_g, a_c):
            raise AssertionError(f"round {rnd}: CUDA and CPU decisions differ")
        for c in range(a_g.shape[0]):
            for node in np.flatnonzero(a_g[c]):
                for _ in range(int(a_g[c, node])):
                    running_g.append((int(node), dem_g[c]))
                    running_c.append((int(node), dem_c[c]))
        return int(a_g.sum())

    placed = 0
    # synchronous rounds (the local runtime's path)
    for rnd in range(4):
        counts = rng.integers(0, n // 5, C).astype(np.int32)
        a_g = pol_gpu.schedule(st_g, demands, counts)
        a_c = pol_cpu.schedule(st_c, demands, counts)
        placed += record((range(C), demands, a_g), (range(C), demands, a_c), rnd)
        assert np.allclose(st_g.available, st_c.available, atol=1e-4)
        release_some(n // 3)
    # pipelined rounds, driven as the live control plane drives them
    queues = np.zeros(C, np.int64)
    tags = [f"class{c}" for c in range(C)]
    rnd = 0
    while rnd < 8 or queues.sum() > 0 or pol_gpu.has_inflight():
        assert rnd < 60, "pipelined rounds did not drain"
        if rnd < 8:
            queues += rng.integers(0, n // 30, C)
        keys = [c for c in range(C) if queues[c] > 0]
        dem = demands[keys] if keys else np.zeros((0, R), np.float32)
        cnt = queues[keys].astype(np.int32)
        ktags = [tags[c] for c in keys]
        plan_g = pol_gpu.schedule_pipelined(st_g, dem, cnt, ktags)
        plan_c = pol_cpu.schedule_pipelined(st_c, dem, cnt, ktags)
        assert (plan_g is None) == (plan_c is None), f"pipelined round {rnd}"
        if plan_g is not None:
            placed += record(plan_g, plan_c, 100 + rnd)
            for c, t in enumerate(plan_g[0]):
                queues[tags.index(t)] -= int(plan_g[2][c].sum())
        release_some(n // 5)
        rnd += 1
    assert (queues >= 0).all()
    assert not pol_cpu.has_inflight()
    log(f"phase 3 policy lockstep: 4 sync + {rnd} pipelined rounds on {n} nodes, "
        f"{placed} placements, CUDA == CPU every round")
    return placed


def phase4_entry_points(torch, KT):
    import ray_tpu_torch as rt

    before = KT.schedule_classes.launches
    rt.init(num_cpus=8, _system_config={
        "scheduling_policy": "torch_cuda", "jax_policy_min_cells": 0,
    })
    try:
        @rt.remote
        def square(x):
            return x * x

        @rt.remote
        def add(a, b):
            return a + b

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self, k):
                self.n += k
                return self.n

        sq = [square.remote(i) for i in range(200)]
        sums = [add.remote(sq[i], sq[i + 1]) for i in range(0, 200, 2)]
        got = rt.get(sums, timeout=120)
        want = [i * i + (i + 1) * (i + 1) for i in range(0, 200, 2)]
        assert got == want, "task results differ"
        c = Counter.remote()
        vals = rt.get([c.incr.remote(k) for k in range(1, 51)], timeout=120)
        assert vals[-1] == sum(range(1, 51)), vals[-1]
        rt_obj = rt.core.api._runtime
        assert rt_obj.policy.name == "torch_cuda"
        assert rt_obj.policy.device.type == "cuda"
    finally:
        rt.shutdown()
    k1 = KT.schedule_classes.launches - before
    assert k1 > 0, "init/remote/get never reached the CUDA kernel"
    log(f"phase 4 entry points: 300 tasks + 1 actor (50 calls) correct, "
        f"K1 launches {k1}")
    return k1


# the GCS phase's 256 task classes: CPU 1..16 x memory 0..15
GCS_CLASSES = [(cpu, mem) for cpu in range(1, 17) for mem in range(16)]


def gcs_submissions(n_tasks, seed, n_classes=len(GCS_CLASSES), deps=None, prefix="t"):
    """Task metas as a driver submits them, classes drawn uniformly."""
    rng = np.random.default_rng(seed)
    metas = []
    for i, c in enumerate(rng.integers(0, n_classes, n_tasks)):
        cpu, mem = GCS_CLASSES[int(c)]
        res = {"CPU": cpu}
        if mem:
            res["memory"] = mem
        meta = {"task_id": f"{prefix}-{i}", "class_key": (("CPU", cpu), ("memory", mem)),
                "resources": res, "num_returns": 1}
        if deps is not None:
            meta["deps"] = [dict(d) for d in deps]
        metas.append(meta)
    return metas


def register_gcs_nodes(testing, gcs, n_nodes):
    """10k fake nodes, CPU 8..64 and memory 32..256, drawn as the JAX
    package's GCS policy tests draw them."""
    rng = np.random.default_rng(42)
    cpus = rng.integers(8, 65, n_nodes)
    mems = rng.integers(32, 257, n_nodes)
    testing.register_fake_nodes(
        gcs, n_nodes, lambda i: {"CPU": int(cpus[i]), "memory": int(mems[i])})


def assert_gcs_drained(gcs):
    with gcs._lock:
        assert not gcs.pending, "GCS: pending not empty"
        assert not gcs.waiting_tasks, "GCS: waiting_tasks not empty"
        assert not gcs.active_outputs, "GCS: active_outputs not empty"
        assert not gcs._class_buckets, "GCS: queued tasks left"


def phase5_gcs(torch, KT, n_nodes=10_000, n_lockstep=6_000, n_pipelined=100_000,
               n_wire=4_000, gpu="cuda", n_profiled=100_000):
    """The GCS scheduling loop at 10k nodes x 256 classes, per algorithm:
    (a) torch_cuda on the card in lockstep with hybrid (NumPy), (b) the
    pipelined torch_cuda GCS, and (c) the wire path into a default GCS.
    The lockstep runs 6 000 tasks (25 000 until phase 20 came, which the
    script's time limit had no room for, PERF.md). Per algorithm, the
    scheduler kernels' launches over (a) and (b) and (b)'s GCS rounds. On a
    card, after (b)'s timed drain, a second pipelined GCS of `n_profiled`
    tasks: what its first round enqueues under torch.profiler, and the
    round after a release of 5 % of the running tasks (dirty rows); the
    refreshes it made (K2 and K3 by form: at least one, and under scan
    every one in K1's launch, or this fails)."""
    from ray_tpu_torch.cluster import testing
    from ray_tpu_torch.cluster.gcs import GcsServer
    from ray_tpu_torch.cluster.rpc import RpcClient
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.core.object_ref import ObjectRef

    out = {}
    for algo in KT.ALGOS:
        before = KT.launch_counts()
        # (a) lockstep: synchronous rounds, every round on the device
        base = {"scheduler_kernel_algo": algo, "scheduler_round_interval_ms": 60_000.0,
                "jax_policy_min_cells": 0, "jax_policy_pipeline_depth": 0}
        placements, secs = {}, {}
        for pol in ("torch_cuda", "hybrid"):
            cfg = {**base, "scheduling_policy": pol, "scheduler_device": gpu}
            gcs = GcsServer(config=Config(cfg))
            try:
                testing.park_scheduler_loop(gcs)
                if pol == "torch_cuda":
                    assert gcs.policy.device.type == gpu
                register_gcs_nodes(testing, gcs, n_nodes)
                conn = testing.FakeConn()
                for meta in gcs_submissions(n_lockstep, seed=7):
                    gcs.rpc_submit_task(meta, conn)
                t0 = time.perf_counter()
                placements[pol] = testing.run_rounds_to_quiescence(gcs, max_rounds=400)
                secs[pol] = time.perf_counter() - t0
                assert_gcs_drained(gcs)
            finally:
                gcs.shutdown()
        p_dev, p_np = placements["torch_cuda"], placements["hybrid"]
        assert len(p_dev) == len(p_np) == n_lockstep, (len(p_dev), len(p_np))
        differ = sum(1 for t in p_np if p_dev[t] != p_np[t])
        if differ:
            raise AssertionError(f"GCS lockstep {algo}: {differ} placements differ")
        rec = {"lockstep_tasks": n_lockstep,
               "lockstep_decisions_per_sec": n_lockstep / secs["torch_cuda"],
               "lockstep_numpy_decisions_per_sec": n_lockstep / secs["hybrid"]}

        # (b) pipelined at the default window and size threshold, as
        # bench.py's gcs_loop_bench drives it
        cfg = {"scheduler_kernel_algo": algo, "scheduler_round_interval_ms": 60_000.0,
               "scheduler_device": gpu}
        gcs = GcsServer(config=Config(cfg))
        try:
            testing.park_scheduler_loop(gcs)
            assert gcs.policy.name == "torch_cuda" and gcs.policy.pipelined
            register_gcs_nodes(testing, gcs, n_nodes)
            conn = testing.FakeConn()
            metas = gcs_submissions(n_pipelined, seed=8)
            t0 = time.perf_counter()
            for meta in metas:
                gcs.rpc_submit_task(meta, conn)
            t_submit = time.perf_counter() - t0
            rounds = [0]
            real_round = gcs._schedule_round

            def counted_round():
                rounds[0] += 1
                return real_round()

            gcs._schedule_round = counted_round
            t0 = time.perf_counter()
            placed = testing.run_rounds_to_quiescence(gcs, max_rounds=2000,
                                                      drain_fraction=1.0)
            t_sched = time.perf_counter() - t0
            assert len(placed) == n_pipelined, (len(placed), n_pipelined)
            assert_gcs_drained(gcs)
            with gcs._lock:
                assert not gcs.policy.has_inflight(), "GCS: rounds left in flight"
                assert not gcs.running
                st = gcs.state
                assert np.allclose(st.available, st.total * st.alive[:, None], atol=1e-3)
        finally:
            gcs.shutdown()
        after = KT.launch_counts()
        forms = refresh_forms(before, after)
        rec.update(tasks=n_pipelined, placed=len(placed),
                   submit_per_sec=n_pipelined / t_submit,
                   decisions_per_sec=len(placed) / t_sched,
                   pipelined_rounds=rounds[0], refreshes=forms,
                   launches={k: after[k] - before[k] for k in KT.KERNELS})
        if gpu == "cuda":
            rec["profiled"] = _gcs_profiled_rounds(torch, KT, testing, GcsServer, Config,
                                                   algo, n_nodes, n_profiled)
        out[algo] = rec
        log(f"phase 5 GCS {algo}: {json.dumps(rec)}")
        if algo == "scan":
            require_fused(forms, "phase 5 (scan)")

    # (c) the wire path: a GCS with the default config (torch_cuda on
    # CUDA), its scheduler loop live, fed over an RPC connection. A
    # producer task runs first; the consumers wait at the dependency gate
    # on its output, and the report of that output (as the producer's
    # node sends it) releases all of them into one round, which the
    # policy solves on the card.
    before = KT.schedule_classes.launches
    before_wire = KT.launch_counts()
    gcs = GcsServer() if gpu == "cuda" else GcsServer(config=Config({"scheduler_device": gpu}))
    try:
        assert gcs.policy.name == "torch_cuda" and gcs.policy.device.type == gpu
        register_gcs_nodes(testing, gcs, n_nodes)
        client = RpcClient("127.0.0.1", gcs.port, name="driver", peer="gcs")
        try:
            driver = "chip-smoke-driver"
            client.call("register_driver", {"driver_id": driver, "worker": False,
                                            "logs": False})
            producer = gcs_submissions(1, seed=0, prefix="producer")[0]
            producer["owner"] = driver
            assert client.call("submit_task", producer).get("ok")
            deadline = time.monotonic() + 60
            while producer["task_id"] not in gcs.running:
                assert time.monotonic() < deadline, "wire path: producer never placed"
                time.sleep(0.01)
            oid = ObjectRef.for_task_output(producer["task_id"], 0).id
            consumers = gcs_submissions(n_wire, seed=9, n_classes=64,
                                        deps=[{"id": oid}], prefix="consumer")
            futs = []
            for meta in consumers:
                meta["owner"] = driver
                futs.append(client.call_async("submit_task", meta))
            for f in futs:
                reply = f.result(timeout=60)
                assert reply.get("ok") and not reply.get("deps_lost"), reply
            with gcs._lock:
                assert len(gcs.waiting_tasks) == n_wire, len(gcs.waiting_tasks)
            node = gcs.running[producer["task_id"]]["node_id"]
            t0 = time.perf_counter()
            client.call("add_object_location", {"object_id": oid, "node_id": node})
            deadline = time.monotonic() + 120
            while True:
                with gcs._lock:
                    n_running = sum(1 for m in consumers if m["task_id"] in gcs.running)
                if n_running == n_wire:
                    break
                assert time.monotonic() < deadline, f"wire path: {n_running}/{n_wire} placed"
                time.sleep(0.005)
            t_place = time.perf_counter() - t0
        finally:
            client.close()
    finally:
        gcs.shutdown()
    k1 = KT.schedule_classes.launches - before
    assert k1 > 0 or gpu != "cuda", "wire path never reached the CUDA kernel"
    forms = refresh_forms(before_wire, KT.launch_counts())
    require_fused(forms, "phase 5c (scan)")
    out["wire"] = {"tasks": n_wire, "classes": 64, "placed_s": t_place, "k1_launches": k1,
                   "refreshes": forms}
    log(f"phase 5 GCS wire path: {json.dumps(out['wire'])}")
    return out


def _gcs_profiled_rounds(torch, KT, testing, GcsServer, Config, algo, n_nodes, n_tasks):
    """Phase 5's pipelined GCS again, apart from its timed drain: the
    launch and copy calls of its first round (the window's first
    submission) and of the round after its running tasks' first 5 % are
    released (dirty rows: update_rows, then the round), under
    torch.profiler, and the refreshes by form from its first round to the
    end of the second profiled one. At least one refresh, and under scan
    none alone, or this fails."""
    cfg = {"scheduler_kernel_algo": algo, "scheduler_round_interval_ms": 60_000.0,
           "scheduler_device": "cuda"}
    gcs = GcsServer(config=Config(cfg))
    try:
        testing.park_scheduler_loop(gcs)
        register_gcs_nodes(testing, gcs, n_nodes)
        conn = testing.FakeConn()
        for meta in gcs_submissions(n_tasks, seed=8):
            gcs.rpc_submit_task(meta, conn)
        before = KT.launch_counts()
        first = kernels_enqueued(torch, gcs._schedule_round, sessions=1, warm=False)
        gcs._schedule_round()  # the window's round fetched, its tasks running
        with gcs._lock:
            running = sorted(gcs.running)
        testing.complete_running(gcs, running[: len(running) // 20])
        after_release = kernels_enqueued(torch, gcs._schedule_round, sessions=1, warm=False)
        forms = refresh_forms(before, KT.launch_counts())
    finally:
        gcs.shutdown()
    if not sum(f["fused"] + f["standalone"] for f in forms.values()):
        raise AssertionError(f"phase 5 {algo}: the profiled GCS made no refresh: {forms}")
    if algo == "scan":
        require_fused(forms, "phase 5 (scan, profiled rounds)")
    return {"refreshes": forms, "rounds_enqueued": {
        name: {"launches": e.launches, "copies": e.copies,
               "kernels": sorted(set(n[:60] for n in e.names))}
        for name, e in (("first", first), ("after_release", after_release))}}


# ------------------------------------------------------------ phase 6: model

# kernel vs plain on the card: (rtol, atol). float32 results: the same
# arithmetic summed in another order; a result rounded to bf16 may differ
# by one rounding (2**-8 relative). block_update's state (o, l) is an
# unnormalised sum over up to 4 096 weighted keys, so its rounding follows
# the largest entry, not each one: there atol is rtol x max |state|.
KERNEL_TOL = {"f32": (1e-5, 1e-5), "bf16": (2.0 ** -7, 1e-3)}
# the model kernels that the forward runs; K8's block form belongs to the
# ring across ranks (phase 11), and is checked here on its own
FORWARD_KERNELS = ("attention", "rmsnorm", "rope_split")
# the model kernels of the line built from attention_sm90.cu (their bf16
# forms, as timed here; float32 stays on model_kernels.cu)
SM90_MODEL_KERNELS = ("attention", "block_update")
MODEL_REPLACES = {
    "block_update": "ray_tpu/parallel/ring_attention.py:41",
    "attention": "ray_tpu/models/transformer.py:113",
    "rmsnorm": "ray_tpu/models/transformer.py:93",
    "rope_split": "ray_tpu/models/transformer.py:98",
}


def phase6a_model_kernels(torch, MK, dev, S=2048):
    """Each model kernel against its plain version on the card at the
    flagship's shapes (B 8, S 2048, H 8, Dh 64, D 512), in bf16 and f32,
    then timed in bf16 at the shapes the forward gives it."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(6)
    B, H, Dh = 8, 8, 64
    D = H * Dh
    rec = {name: {"max_abs_err": 0.0} for name in MODEL_REPLACES}
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, dt)

    def check(name, got, want, what, sum_state=False):
        rtol, atol = KERNEL_TOL["f32" if want.dtype == torch.float32 else "bf16"]
        got, want = got.double(), want.double()
        if sum_state:
            atol = max(atol, rtol * float(want.abs().max()))
        d = float((got - want).abs().max())
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], d)
        bad = (got - want).abs() > atol + rtol * want.abs()
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {what}: kernel != plain (max abs err {d}, "
                                 f"tolerance rtol {rtol} atol {atol})")

    # K8 with its m and l (a rehearsal on the CPU takes the plain version)
    launch = MK._attention_launch if dev.type == "cuda" else \
        (lambda q, k, v, causal, _round, stats: MK._attention_rounded_plain(q, k, v, causal))
    for dt in (torch.bfloat16, torch.float32):
        for s_len in (S, S - 1):
            q, k, v = (rnd((B, s_len, H, Dh), dt) for _ in range(3))
            check("attention", MK.attention(q, k, v), MK._attention_plain(q, k, v),
                  f"{names[dt]} S={s_len}")
            # the forward's form: probabilities rounded to the dtype (bf16:
            # the tensor-core kernel), with the rows' m and l, and a second
            # launch giving the same bits
            got = launch(q, k, v, True, True, stats=True)
            want = MK._attention_rounded_plain(q, k, v, True)
            for part, a, b in zip(("out", "m", "l"), got, want):
                check("attention", a, b, f"{names[dt]} S={s_len} rounded probabilities, "
                      f"{part}", sum_state=part != "out")
            again = launch(q, k, v, True, True, stats=True)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"attention {names[dt]} S={s_len}: two launches gave "
                                     "different bits")
        # a fully visible block sets the state, then the diagonal block, then
        # one wholly above the diagonal (must leave the state as it is)
        q, k, v = (rnd((B, S, H, Dh), dt) for _ in range(3))
        state = (torch.zeros((B, S, H, Dh), device=dev),
                 torch.full((B, H, S), MK.NEG_INF, device=dev),
                 torch.zeros((B, H, S), device=dev))
        # (bf16: the tensor-core kernel, its P·V as two bf16 parts of P; f32:
        # the CUDA cores), a second launch giving the same bits
        for q_off, k_off, what in ((S, 0, "visible"), (S, S, "diagonal"),
                                   (S, 2 * S, "fully masked")):
            tc = MK.block_update.launches_tc
            got = MK.block_update(q, k, v, *state, q_off, k_off, True, 1.0 / np.sqrt(Dh))
            if dev.type == "cuda" and MK.block_update.launches_tc - tc != (dt == torch.bfloat16):
                raise AssertionError(f"block_update {names[dt]}: not the "
                                     f"{MK._block_update_route(q)} route")
            want = MK._block_update_plain(q, k, v, *state, q_off, k_off, True,
                                          1.0 / np.sqrt(Dh))
            for part, a, b in zip("oml", got, want):
                check("block_update", a, b, f"{names[dt]} {what} block, {part}",
                      sum_state=True)
            again = MK.block_update(q, k, v, *state, q_off, k_off, True, 1.0 / np.sqrt(Dh))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"block_update {names[dt]} {what}: two launches gave "
                                     "different bits")
            if what == "fully masked" and not all(torch.equal(a, b)
                                                  for a, b in zip(got, state)):
                raise AssertionError("block_update: a fully masked block changed the state")
            state = want
        x, scale = rnd((B * S, D), dt, 3.0), rnd((D,), torch.float32)
        check("rmsnorm", MK.rmsnorm(x, scale), MK._rmsnorm_plain(x, scale), names[dt])
        qkv = rnd((B, S, 3 * D), dt)
        if dev.type == "cuda" and MK.rope_split_form(qkv, H) != "rows":
            raise AssertionError(f"rope_split {names[dt]}: not the rows form at the "
                                 "forward's shapes")
        got = MK.rope_split(qkv, H, 1e4)
        for part, a, b in zip("qkv", got, MK._rope_split_plain(qkv, H, 1e4)):
            check("rope_split", a, b, f"{names[dt]} {part}")
        if not all(torch.equal(a, b) for a, b in zip(got, MK.rope_split(qkv, H, 1e4))):
            raise AssertionError(f"rope_split {names[dt]}: two launches gave different bits")

    bf = torch.bfloat16
    # K8, whole form, as the forward calls it: causal, [8, 2048, 8, 64] bf16,
    # probabilities rounded (the tensor-core kernel); beside it the CUDA-core
    # kernel in bf16 with float32 probabilities and in float32
    q, k, v = (rnd((B, S, H, Dh), bf) for _ in range(3))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = S * (S + 1) // 2  # causal (query, key) pairs a head
    rec["attention"].update(
        ms=time_ms(torch, lambda: MK.attention(q, k, v, round_probs=True)),
        ms_unrounded=time_ms(torch, lambda: MK.attention(q, k, v)),
        ms_f32_cuda_core=time_ms(torch, lambda: MK.attention(q32, k32, v32, round_probs=True)),
        plain_ms=time_ms(torch, lambda: MK._attention_plain(q, k, v, round_probs=True),
                         reps=3, warm=1),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        bound=bound(4 * B * S * H * Dh * 2, 4 * B * H * Dh * pairs, PEAK_BF16_OPS_PER_S))
    # K8, block form, as the ring schedule of (d) calls it: a visible
    # [8, 512, 8, 64] block (4 shards of 2048) against a running state, in
    # bf16 (the tensor-core kernel) and f32 (the CUDA cores)
    Sb = S // 4
    qb, kb, vb = (rnd((B, Sb, H, Dh), bf) for _ in range(3))
    st = (rnd((B, Sb, H, Dh), torch.float32), rnd((B, H, Sb), torch.float32),
          rnd((B, H, Sb), torch.float32).abs() + 1)
    args = (qb, kb, vb, *st, Sb, 0, True, 1.0 / np.sqrt(Dh))
    args32 = (qb.float(), kb.float(), vb.float(), *args[3:])
    # the calls timed below, held first against the plain version (the same
    # for both dtypes, since it takes q, k, v in float32)
    want = MK._block_update_plain(*args)
    for dt_name, a in (("bf16", args), ("f32", args32)):
        for part, x, y in zip("oml", MK.block_update(*a), want):
            check("block_update", x, y, f"{dt_name} timed block [{B}, {Sb}, {H}, {Dh}], "
                  f"{part}", sum_state=True)
    rec["block_update"].update(
        ms=time_ms(torch, lambda: MK.block_update(*args)),
        ms_f32_cuda_core=time_ms(torch, lambda: MK.block_update(*args32)),
        plain_ms=time_ms(torch, lambda: MK._block_update_plain(*args), reps=3, warm=1),
        library_ms=None,
        # q, k, v read, the state (o, m, l) read and written once; Q·K^T
        # in bf16 and the float32 P·V counted as the two bf16 products (hi·V
        # and lo·V) that carry it on the tensor cores, 3 x 2·B·H·Sb²·Dh at
        # the bf16 peak: the least the card takes for a float32-accurate
        # product, since at the CUDA cores' float32 peak P·V alone would
        # take 0.032 ms, which the split beats (PERF.md §6)
        bound=bound(3 * B * Sb * H * Dh * 2 + 2 * (B * Sb * H * Dh + 2 * B * H * Sb) * 4,
                    3 * 2 * B * H * Dh * Sb * Sb, PEAK_BF16_OPS_PER_S))
    x, scale = rnd((B * S, D), bf), rnd((D,), torch.float32)
    scale_bf = scale.to(bf)
    rec["rmsnorm"].update(
        ms=time_ms(torch, lambda: MK.rmsnorm(x, scale), reps=21),
        plain_ms=time_ms(torch, lambda: MK._rmsnorm_plain(x, scale), reps=21),
        library_ms=time_ms(torch, lambda: F.rms_norm(x, (D,), scale_bf, 1e-6), reps=21),
        bound=bound(2 * B * S * D * 2 + D * 4, 4 * B * S * D))
    qkv = rnd((B, S, 3 * D), bf)
    rec["rope_split"].update(
        ms=time_ms(torch, lambda: MK.rope_split(qkv, H, 1e4), reps=21),
        plain_ms=time_ms(torch, lambda: MK._rope_split_plain(qkv, H, 1e4), reps=21),
        library_ms=None,
        bound=bound(2 * B * S * 3 * D * 2, 6 * B * S * D))
    for name, r in rec.items():
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']} ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}), "
            f"max abs err {r['max_abs_err']:.3g}")
    log(f"  attention f32 (CUDA cores): {rec['attention']['ms_f32_cuda_core']:.4f} ms; bf16 "
        f"unrounded (CUDA cores): {rec['attention']['ms_unrounded']:.4f} ms")
    log(f"  block_update f32 (CUDA cores): {rec['block_update']['ms_f32_cuda_core']:.4f} ms")
    return rec


def _golden_check(torch, PT, tree, golden, dt_name, dev):
    """The forward and loss on the card at the golden's tokens [2, 513]
    against the JAX package's numbers (models.transformer.GOLDEN_TOL)."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt_name]
    model = PT.params_from_numpy(tree, PT.TransformerConfig(dtype=dt), device=dev)
    tokens = torch.from_numpy(golden["tokens"]).to(dev)
    pos = [int(p) for p in golden["positions"]]
    logits = PT.forward(model, tokens[:, :-1])
    loss = float(PT.loss_fn(model, {"tokens": tokens}))
    atol_logits, atol_loss, agree = PT.GOLDEN_TOL[dt_name]
    err = float(np.abs(logits[:, pos].cpu().numpy() - golden[f"logits_{dt_name}"]).max())
    share = float((logits.argmax(-1).cpu().numpy() == golden[f"argmax_{dt_name}"]).mean())
    loss_err = abs(loss - float(golden[f"loss_{dt_name}"]))
    if not (err <= atol_logits and share >= agree and loss_err <= atol_loss):
        raise AssertionError(
            f"golden {dt_name}: logits err {err} (atol {atol_logits}), argmax agree "
            f"{share} (>= {agree}), loss err {loss_err} (atol {atol_loss})")
    return {"logits_err": err, "argmax_agree": share, "loss_err": loss_err}


def ring_schedule(torch, MK, q, k, v, n_shards):
    """The ring's block steps in one process, as check code (phase 11 holds
    the port's ring_attention across ranks to it): query block idx meets,
    at ring step t, the KV block of shard (idx - t) mod n_shards, through
    K8's block form; then o / max(l, 1e-30) in q's dtype."""
    B, S, H, Dh = q.shape
    Sb = S // n_shards
    outs = []
    for idx in range(n_shards):
        qb = q[:, idx * Sb:(idx + 1) * Sb].contiguous()
        o = torch.zeros((B, Sb, H, Dh), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, Sb), MK.NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, Sb), dtype=torch.float32, device=q.device)
        for t in range(n_shards):
            src = (idx - t) % n_shards
            kb, vb = (x[:, src * Sb:(src + 1) * Sb].contiguous() for x in (k, v))
            o, m, l = MK.block_update(qb, kb, vb, o, m, l, idx * Sb, src * Sb, True,
                                      1.0 / np.sqrt(Dh))
        outs.append((o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def phase6b_forward(torch, PT, make_forward_step, dev, batch=8, seq=2048, cfg=None):
    """The main path, called directly: make_forward_step on [batch, seq]
    tokens, its logits finite and of the right shape, then timed. The
    weights come from the golden's numpy seed (checksum checked first)."""
    flagship = PT.TransformerConfig()
    cfg = cfg or flagship
    golden = np.load(GOLDEN_PATH)
    seed = int(golden["weight_seed"])
    golden_tree = PT.numpy_params(flagship, seed)
    checksum = PT.weights_checksum(golden_tree)
    if checksum != str(golden["checksum"]):
        raise AssertionError(
            f"numpy_params gave other weights than the golden's (checksum {checksum[:16]} "
            f"!= {str(golden['checksum'])[:16]}): this numpy draws other numbers from "
            "the seed, so the golden does not apply")
    tree = golden_tree if cfg == flagship else PT.numpy_params(cfg, seed)
    model = PT.params_from_numpy(tree, cfg, device=dev)
    fwd = make_forward_step(cfg) if dev.type == "cuda" else make_forward_step(cfg, dev)
    rng = np.random.default_rng(60)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    logits = fwd(model, tokens[:, :-1])
    sync(torch, dev)
    if tuple(logits.shape) != (batch, seq, cfg.vocab_size) or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"forward: logits {tuple(logits.shape)} {logits.dtype}, "
                             "or not finite")
    fwd_ms = time_ms(torch, lambda: fwd(model, tokens[:, :-1]), reps=5, warm=1) \
        if dev.type == "cuda" else float("nan")
    res = {"batch": batch, "seq": seq, "forward_ms": fwd_ms,
           "tokens_per_s": batch * seq / (fwd_ms / 1e3)}
    log(f"phase 6b forward: {json.dumps(res)}")
    ctx = {"cfg": cfg, "golden": golden, "golden_tree": golden_tree, "tree": tree,
           "model": model, "fwd": fwd, "tokens": tokens, "logits": logits}
    return res, ctx


class ModelServer:
    """User code, served from an actor by phase 6c (local mode), phase 13b
    (a worker process of a cluster) and phase 14 (a serve replica and a
    compiled graph's stage): holds the model on `device` and answers
    requests with the last position's logits."""

    def __init__(self, weights, cfg, device):
        import ray_tpu_torch as rt
        from ray_tpu_torch.models import transformer as PT
        from ray_tpu_torch.parallel import make_forward_step

        if isinstance(weights, rt.ObjectRef):  # bound to a serve deployment
            weights = rt.get(weights, timeout=600)
        self.model = PT.params_from_numpy(weights, cfg, device=device)
        self.fwd = make_forward_step(cfg) if device.type == "cuda" \
            else make_forward_step(cfg, device)

    def last_logits(self, tokens):
        return self.fwd(self.model, tokens)[:, -1].cpu().numpy()

    def __call__(self, payload):
        """An HTTP request's JSON body {"tokens": [[...]]}: the last
        position's logits as lists (float32 values, exact in JSON)."""
        tokens = np.asarray(payload["tokens"], dtype=np.int32)
        return {"logits": self.last_logits(tokens).tolist()}

    def pid(self):
        return os.getpid()

    def launches(self):
        from ray_tpu_torch.models import kernels as MK

        return MK.launch_counts(), MK.tc_launch_counts()


def phase6c_serve(ctx, sizes=None):
    """The main path, served: an actor of ray_tpu_torch.init() (default
    config: the torch_cuda policy on the card) holds the model and answers
    8 requests with the last position's logits. Checked in 6d."""
    import ray_tpu_torch as rt

    cfg, tree, dev = ctx["cfg"], ctx["tree"], ctx["model"].device
    sizes = sizes or [(8, 2048), (4, 1024), (1, 2048), (2, 17), (8, 512), (3, 1000),
                      (1, 1), (6, 2047)]
    rng = np.random.default_rng(61)
    requests = [rng.integers(0, cfg.vocab_size, s).astype(np.int32) for s in sizes]
    if dev.type == "cuda":
        rt.init(num_cpus=8)  # the default config: torch_cuda on the card
    else:
        rt.init(num_cpus=8, _system_config={"scheduler_device": "cpu"})
    try:
        server = rt.remote(ModelServer).remote(tree, cfg, dev)
        t0 = time.perf_counter()
        answers = rt.get([server.last_logits.remote(t) for t in requests], timeout=600)
        t_serve = time.perf_counter() - t0
        policy = rt.core.api._runtime.policy
        assert policy.name == "torch_cuda" and policy.device.type == dev.type, policy.name
    finally:
        rt.shutdown()
    res = {"requests": len(requests), "tokens": int(sum(t.size for t in requests)),
           "serve_s": t_serve}
    log(f"phase 6c served: {json.dumps(res)}")
    return res, requests, answers


def phase6d_checks(torch, PT, MK, ctx, requests, answers):
    """The main path's results checked, outside its counting window: two
    sequences against the port's plain forward on the CPU, the loss at
    [batch, seq + 1], both dtypes against the JAX golden, each served
    answer against the direct call, and the ring's schedule of K8 block
    steps against the whole-sequence kernel."""
    cfg, model, fwd, logits = ctx["cfg"], ctx["model"], ctx["fwd"], ctx["logits"]
    dev = model.device
    tokens = ctx["tokens"]
    cpu_model = PT.params_from_numpy(ctx["tree"], cfg, device="cpu")
    cpu_logits = PT.forward(cpu_model, torch.from_numpy(tokens[:2, :-1]))
    atol_logits, atol_loss, agree = PT.GOLDEN_TOL[
        "bf16" if cfg.dtype == torch.bfloat16 else "f32"]
    cpu_err = float((logits[:2].cpu() - cpu_logits).abs().max())
    cpu_agree = float((logits[:2].argmax(-1).cpu() == cpu_logits.argmax(-1)).float().mean())
    if cpu_err > atol_logits or cpu_agree < agree:
        raise AssertionError(f"forward: card vs CPU logits err {cpu_err} (atol "
                             f"{atol_logits}), argmax agree {cpu_agree} (>= {agree})")
    # the loss at [batch, seq + 1], held against the cross-entropy of the
    # forward's logits
    tok = torch.from_numpy(tokens).to(dev)
    loss = float(PT.loss_fn(model, {"tokens": tok}))
    ce = float(torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), tok[:, 1:].reshape(-1).long()))
    if not np.isfinite(loss) or abs(loss - ce) > 1e-4:
        raise AssertionError(f"loss_fn {loss} != cross-entropy of the forward {ce}")
    golden_res = {dt: _golden_check(torch, PT, ctx["golden_tree"], ctx["golden"], dt, dev)
                  for dt in PT.GOLDEN_TOL}
    for t, a in zip(requests, answers):
        want = fwd(model, t)[:, -1].cpu().numpy()
        if a.shape != want.shape or not np.array_equal(a, want):
            raise AssertionError(f"served answer for {t.shape} differs from the direct call")
    # the ring's schedule (4 shards: 16 block steps, 6 of them fully masked)
    # on layer 0's q, k, v against the whole-sequence kernel
    blk = model.blocks[0]
    x = torch.nn.functional.embedding(tok[:, :-1], model.embed).to(cfg.dtype)
    qkv = torch.matmul(MK.rmsnorm(x, blk.ln1), blk.wqkv.to(cfg.dtype))
    q, k, v = MK.rope_split(qkv, cfg.n_heads, cfg.rope_theta)
    before, before_tc = MK.block_update.launches, MK.block_update.launches_tc
    ring = ring_schedule(torch, MK, q, k, v, n_shards=4)
    ring_launches = MK.block_update.launches - before
    ring_tc = MK.block_update.launches_tc - before_tc
    whole = MK.attention(q, k, v, causal=True)
    rtol, atol = KERNEL_TOL["bf16" if cfg.dtype == torch.bfloat16 else "f32"]
    ring_err = float((ring.double() - whole.double()).abs().max())
    if bool(((ring.double() - whole.double()).abs() > atol + rtol * whole.double().abs()).any()):
        raise AssertionError(f"ring schedule != whole attention (max abs err {ring_err})")
    if dev.type == "cuda" and ring_launches != 16:
        raise AssertionError(f"ring schedule: {ring_launches} block_update launches, not 16")
    # bf16 steps go to the tensor-core kernel, every one of them
    if dev.type == "cuda" and ring_tc != (ring_launches if q.dtype == torch.bfloat16 else 0):
        raise AssertionError(f"ring schedule: {ring_tc} of {ring_launches} {q.dtype} "
                             "block_update launches on the tensor cores")
    res = {"cpu_logits_err": cpu_err, "cpu_argmax_agree": cpu_agree, "loss": loss,
           "golden": golden_res, "served_equal_direct": len(answers),
           "ring_vs_whole_err": ring_err, "ring_block_update_launches": ring_launches,
           "ring_block_update_launches_tc": ring_tc}
    log(f"phase 6d checks: {json.dumps(res)}")
    return res


# ------------------------------------------------------------ phase 7: experts

# the expert layer's main path: MoEConfig() (d_model 256, d_ff 512, 8
# experts, capacity factor 1.25, bf16) on x [8, 2048, 256] bf16, C = 320
MOE_SHAPE = (8, 2048, 256)
MOE_X_SEED = 70
# (the forward's kernels; the backward's are phase 10's)
MOE_REPLACES = {
    "moe_route": "ray_tpu/models/moe.py:70",
    "moe_dispatch": "ray_tpu/models/moe.py:83",
    "moe_combine": "ray_tpu/models/moe.py:110",
}
# K9a's gate and probability sums against the plain version's: expf and
# the order of the sums (relative)
ROUTE_TOL = 1e-6


def _route_err(torch, got, want, what):
    """K9a's outputs against another's: expert, slot, token_of_slot and the
    token counts equal, gate and the probability sums within ROUTE_TOL
    relative. Returns the largest gate / sum difference."""
    names = ("expert", "gate", "slot", "token_of_slot", "stats")
    for name, a, b in zip(names, got, want):
        if name in ("gate", "stats"):
            continue
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"moe_route {what}: {name} differs "
                                 f"({int((a.cpu() != b.cpu()).sum())} entries)")
    if not torch.equal(got[4][:, 0].cpu(), want[4][:, 0].cpu()):
        raise AssertionError(f"moe_route {what}: token counts differ")
    err = 0.0
    for a, b in ((got[1], want[1]), (got[4][:, 1], want[4][:, 1])):
        a, b = a.double().cpu(), b.double().cpu()
        d = (a - b).abs()
        if bool((d > ROUTE_TOL * b.abs()).any()):
            raise AssertionError(f"moe_route {what}: gate or sums off by {float(d.max())}")
        err = max(err, float(d.max()))
    return err


def _route_chunk_edges(torch, EK, dev):
    """K9a against its plain version where its chunks of 256 tokens meet
    (the look-back's edges): S = 1, 255, 256, 257, 2 049 and 8 192 at E =
    1, 8, 9 and 64, three groups skewed toward expert 0, ties at the top
    between experts 1 and E - 1 on every third token; at C = 1, C = S and a
    C that expert 0 of group 0 overflows in the middle of a chunk; then a
    grid larger than the card's resident blocks (G 64, S 16 384, E 8: 4 096
    blocks). Each call launched twice, the bits equal. Returns the largest
    gate / sum difference."""
    rng = np.random.default_rng(31)
    T = EK.ROUTE_TOKENS_A_BLOCK
    err = 0.0

    def check(lt, C, what):
        got = EK.moe_route(lt, C)
        if not all(torch.equal(a, b) for a, b in zip(got, EK.moe_route(lt, C))):
            raise AssertionError(f"moe_route {what} C={C}: two launches gave different bits")
        return got, _route_err(torch, got, EK._route_plain(lt, C), f"{what} C={C}")

    for E in (1, 8, 9, 64):
        for S in (1, T - 1, T, T + 1, 2049, 8192):
            logits = (rng.standard_normal((3, S, E)) * 2).astype(np.float32)
            logits[:, :, 0] += 1.0
            if E > 1:
                logits[:, ::3, 1] = logits[:, ::3, E - 1] = 30.0
            lt = torch.from_numpy(logits).to(dev)
            (expert, *_), e = check(lt, S, f"E={E} S={S}")
            if E > 1 and not bool((expert[:, ::3] == 1).all()):
                raise AssertionError(f"moe_route E={E} S={S}: a tie went to another expert")
            # expert 0 of group 0 overflows at a routed token inside a chunk
            routed = np.flatnonzero(expert[0].cpu().numpy() == 0)
            inside = [s for s in routed[1:] if s % T not in (0, T - 1)]
            later = [s for s in inside if s >= T]
            for C in [1] + ([int((routed < min(later or inside, key=lambda s: abs(s - S // 2)))
                                 .sum())] if inside else []):
                e = max(e, check(lt, C, f"E={E} S={S}")[1])
            err = max(err, e)
    G, S, E = 64, 16384, 8
    lt = torch.from_numpy((rng.standard_normal((G, S, E)) * 2).astype(np.float32)).to(dev)
    blocks = EK.route_plan(G, S, E).blocks
    if dev.type == "cuda":
        resident = torch.cuda.get_device_properties(dev).multi_processor_count * 8
        if blocks <= resident:
            raise AssertionError(f"moe_route: {blocks} blocks fit the card's {resident}")
    err = max(err, check(lt, int(S * 1.25 / E), f"G={G} S={S} E={E}")[1])
    log(f"  moe_route at its chunk edges (S 1 to 8 192, E 1 to 64, three capacities, ties) "
        f"and G {G} x S {S} ({blocks} blocks): equal to plain, two launches bit-equal, max "
        f"gate / sum err {err:.3g}")
    return err


def _moe_layer(torch, PM, dev):
    """The main path's weights (the golden's numpy seed, checksum checked)
    and its skewed tokens [8, 2048, 256] float32 on `dev`."""
    golden = np.load(MOE_GOLDEN_PATH)
    cfg = PM.MoEConfig()
    tree = PM.numpy_moe_params(cfg, int(golden["weight_seed"]))
    checksum = PM.moe_weights_checksum(tree)
    if checksum != str(golden["checksum"]):
        raise AssertionError(
            f"numpy_moe_params gave other weights than the golden's (checksum "
            f"{checksum[:16]} != {str(golden['checksum'])[:16]}): this numpy draws "
            "other numbers from the seed, so the golden does not apply")
    x = PM.numpy_moe_inputs(tree, MOE_SHAPE, MOE_X_SEED, float(golden["skew"]))
    return cfg, tree, golden, torch.from_numpy(x).to(dev)


def phase7a_moe_kernels(torch, PM, EK, dev):
    """Each expert-layer kernel against its plain version on the card at the
    main path's shapes (logits [8, 2048, 8], C 320, rows of 256), the
    routing and both copies in bf16 and f32, then timed as the main path
    calls them (bf16 tokens and experts)."""
    cfg, tree, _, x32 = _moe_layer(torch, PM, dev)
    G, S, D = MOE_SHAPE
    E, C = cfg.n_experts, PM._capacity(cfg, S)
    logits = torch.matmul(x32, torch.from_numpy(tree["router"]).to(dev))
    rec = {name: {"max_abs_err": 0.0} for name in MOE_REPLACES}
    got = EK.moe_route(logits, C)
    rec["moe_route"]["max_abs_err"] = _route_err(torch, got, EK._route_plain(logits, C),
                                                 "main path")
    _route_err(torch, EK.moe_route(logits, C), got, "main path, a second launch")
    if not all(torch.equal(a, b) for a, b in zip(got, EK.moe_route(logits, C))):
        raise AssertionError("moe_route main path: two launches gave different bits")
    rec["moe_route"]["max_abs_err"] = max(rec["moe_route"]["max_abs_err"],
                                          _route_chunk_edges(torch, EK, dev))
    _, gate, slot, tos, _ = got
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    for x_name, x_dt in dt.items():
        x = x32.to(x_dt)
        for o_name, o_dt in dt.items():
            if not torch.equal(EK.moe_dispatch(x, tos, o_dt), EK._dispatch_plain(x, tos, o_dt)):
                raise AssertionError(f"moe_dispatch x {x_name} -> {o_name}: kernel != plain")
    out = torch.randn((E, G, C, D), generator=torch.Generator(dev).manual_seed(7), device=dev)
    for y_name, y_dt in dt.items():
        if not torch.equal(EK.moe_combine(out, slot, gate, y_dt),
                           EK._combine_plain(out, slot, gate, y_dt)):
            raise AssertionError(f"moe_combine -> {y_name}: kernel != plain")

    bf = torch.bfloat16
    x = x32.to(bf)
    kept = int((tos >= 0).sum())
    rec["moe_route"].update(
        ms=time_ms(torch, lambda: EK.moe_route(logits, C), reps=21),
        plain_ms=time_ms(torch, lambda: EK._route_plain(logits, C), reps=7),
        library_ms=None,
        # logits read; expert, gate, slot, token_of_slot and stats written;
        # a token: E subtractions, exps, additions, divisions, comparisons
        bound=bound(G * S * E * 4 + G * S * 12 + E * G * C * 4 + G * 2 * E * 4,
                    5 * G * S * E))
    # the gather alone as the library yardstick: the same rows of x in one
    # index_select (no cast, no zero fill)
    flat = x.reshape(G * S, D)
    rows = (torch.arange(G, device=dev)[None, :, None] * S + tos.clamp_min(0)).reshape(-1)
    rec["moe_dispatch"].update(
        ms=time_ms(torch, lambda: EK.moe_dispatch(x, tos, bf), reps=21),
        plain_ms=time_ms(torch, lambda: EK._dispatch_plain(x, tos, bf), reps=21),
        library_ms=time_ms(torch, lambda: torch.index_select(flat, 0, rows), reps=21),
        bound=bound(E * G * C * 4 + kept * D * 2 + E * G * C * D * 2, 0))
    out_flat = out.reshape(E * G * C, D)
    src = torch.where(slot >= 0, (slot // C * G + torch.arange(G, device=dev)[:, None]) * C
                      + slot % C, 0).reshape(-1).long()
    rec["moe_combine"].update(
        ms=time_ms(torch, lambda: EK.moe_combine(out, slot, gate, bf), reps=21),
        plain_ms=time_ms(torch, lambda: EK._combine_plain(out, slot, gate, bf), reps=21),
        library_ms=time_ms(torch, lambda: torch.index_select(out_flat, 0, src), reps=21),
        bound=bound(G * S * 8 + kept * D * 4 + G * S * D * 2, kept * D))
    log(f"  {kept} of {E * G * C} slots full; moe_route in one launch of "
        f"{EK.route_plan(G, S, E).blocks} blocks")
    for name, r in rec.items():
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, gather alone "
            f"{r['library_ms']} ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}), "
            f"max abs err {r['max_abs_err']:.3g}")
    return rec


def phase7b_moe(torch, PM, dev):
    """The expert layer's main path, called directly: moe_ffn on the skewed
    x [8, 2048, 256] bf16, y finite, in bf16, with some tokens dropped;
    then timed (CUDA events, and the host clock over 21 calls)."""
    cfg, tree, golden, x32 = _moe_layer(torch, PM, dev)
    model = PM.moe_params_from_numpy(tree, cfg, device=dev)
    x = x32.to(torch.bfloat16)
    y, aux = PM.moe_ffn(model, x)
    sync(torch, dev)
    if tuple(y.shape) != MOE_SHAPE or y.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(y).all()) or aux.dim() != 0 \
            or not np.isfinite(float(aux)):
        raise AssertionError(f"moe_ffn: y {tuple(y.shape)} {y.dtype}, aux {aux}")
    dropped = float((y == 0).all(-1).float().mean())
    if not dropped > 0:
        raise AssertionError("moe_ffn: the skewed routing dropped no token")
    G, S, _ = MOE_SHAPE
    res = {"shape": list(MOE_SHAPE), "capacity": PM._capacity(cfg, S),
           "dropped_share": dropped, "aux": float(aux)}
    if dev.type == "cuda":
        ms = time_ms(torch, lambda: PM.moe_ffn(model, x), reps=21)
        sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(21):
            PM.moe_ffn(model, x)
        sync(torch, dev)
        res.update(ms=ms, tokens_per_s=G * S / (ms / 1e3),
                   wall_ms=(time.perf_counter() - t0) / 21 * 1e3)
    log(f"phase 7b moe_ffn: {json.dumps(res)}")
    ctx = {"cfg": cfg, "tree": tree, "golden": golden, "model": model, "x": x, "y": y,
           "aux": aux}
    return res, ctx


def phase7c_moe_serve(torch, PM, ctx, sizes=None):
    """The expert layer served: an actor of ray_tpu_torch.init() (default
    config: the torch_cuda policy on the card) holds the layer and answers
    8 requests of assorted [G, S] (S = 1, a ragged S and G = 1 among them)
    with y and aux. Checked in 7d."""
    import ray_tpu_torch as rt

    cfg, tree, dev = ctx["cfg"], ctx["tree"], ctx["model"].device
    sizes = sizes or [(8, 2048), (4, 1024), (1, 2048), (2, 17), (8, 512), (3, 1000),
                      (1, 1), (6, 2047)]
    rng = np.random.default_rng(71)
    requests = [PM.numpy_moe_inputs(tree, (g, s, cfg.d_model), int(rng.integers(1 << 30)))
                for g, s in sizes]
    if dev.type == "cuda":
        rt.init(num_cpus=8)  # the default config: torch_cuda on the card
    else:
        rt.init(num_cpus=8, _system_config={"scheduler_device": "cpu"})
    try:
        @rt.remote
        class ExpertServer:
            """User code: holds the expert layer on the card, answers requests."""

            def __init__(self, weights):
                self.layer = PM.moe_params_from_numpy(weights, cfg, device=dev)

            def forward(self, x):
                y, aux = self.layer(torch.from_numpy(x).to(dev, torch.bfloat16))
                return y.float().cpu().numpy(), float(aux)

        server = ExpertServer.remote(tree)
        t0 = time.perf_counter()
        answers = rt.get([server.forward.remote(r) for r in requests], timeout=600)
        t_serve = time.perf_counter() - t0
        policy = rt.core.api._runtime.policy
        assert policy.name == "torch_cuda" and policy.device.type == dev.type, policy.name
    finally:
        rt.shutdown()
    res = {"requests": len(requests), "tokens": int(sum(r.shape[0] * r.shape[1]
                                                        for r in requests)),
           "serve_s": t_serve}
    log(f"phase 7c served: {json.dumps(res)}")
    return res, requests, answers


def phase7d_moe_checks(torch, PM, EK, ctx, requests, answers):
    """The expert layer's results checked, outside its counting window: K9a
    on the golden's JAX logits against JAX's routing; moe_ffn on the
    golden's x in both expert dtypes against the golden's y and aux, over
    the groups free of near-ties; two groups of 7b against the port's plain
    moe_ffn on the CPU; each served answer against the direct call."""
    cfg, model, golden, dev = ctx["cfg"], ctx["model"], ctx["golden"], ctx["model"].device
    S = golden["logits"].shape[1]
    C = PM._capacity(cfg, S)
    expert, gate, slot, _, _ = EK.moe_route(torch.from_numpy(golden["logits"]).to(dev), C)
    if not (np.array_equal(expert.cpu().numpy(), golden["expert"])
            and np.array_equal(slot.cpu().numpy(), golden["slot"])):
        raise AssertionError("moe_route on the golden's logits: routing != JAX's")
    gate_err = float(np.abs(gate.cpu().numpy() - golden["gate"]).max())
    if gate_err > ROUTE_TOL:
        raise AssertionError(f"moe_route on the golden's logits: gate off by {gate_err}")

    tree = ctx["tree"]
    xg = torch.from_numpy(PM.numpy_moe_inputs(tree, golden["logits"].shape[:2] + (cfg.d_model,),
                                              int(golden["x_seed"]), float(golden["skew"])))
    clean = golden["gap"].min(axis=1) >= PM.MOE_TIE_GAP
    if not clean.any():
        raise AssertionError("every golden group holds a near-tie: nothing to compare")
    pos = golden["positions"]
    golden_res = {"groups_left_out": int((~clean).sum()), "routing_equal": True,
                  "gate_err": gate_err}
    for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        layer = PM.moe_params_from_numpy(tree, PM.MoEConfig(dtype=dt), device=dev)
        y, aux = PM.moe_ffn(layer, xg.to(dev))
        y = y.cpu().numpy()
        got = np.stack([y[i, pos[i]] for i in range(len(pos))])[clean]
        want = golden[f"y_{dt_name}"][clean]
        y_tol, aux_tol = PM.MOE_GOLDEN_TOL[dt_name]
        err = float(np.abs(got - want).max())
        aux_err = abs(float(aux) - float(golden[f"aux_{dt_name}"]))
        zeros_equal = np.array_equal((got == 0).all(-1), (want == 0).all(-1))
        if err > y_tol or aux_err > aux_tol or not zeros_equal:
            raise AssertionError(f"golden {dt_name}: y err {err} (atol {y_tol}), aux err "
                                 f"{aux_err} (atol {aux_tol}), dropped rows equal {zeros_equal}")
        golden_res[dt_name] = {"y_err": err, "aux_err": aux_err}

    # two groups of 7b free of near-ties against the plain moe_ffn on the CPU
    x = ctx["x"]
    probs = EK.softmax_plain(torch.matmul(x.float(), model.router)).cpu()
    top2 = probs.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).amin(-1)
    groups = [int(g) for g in torch.nonzero(gaps >= PM.MOE_TIE_GAP).flatten()[:2]]
    if len(groups) < 2:
        raise AssertionError(f"fewer than two groups of 7b free of near-ties: {gaps.tolist()}")
    cpu_layer = PM.moe_params_from_numpy(tree, cfg, device="cpu")
    y_cpu, _ = PM.moe_ffn(cpu_layer, x[groups].cpu())
    y_dev = ctx["y"][groups].cpu()
    cpu_err = float((y_dev.float() - y_cpu.float()).abs().max())
    bad = (y_dev.float() - y_cpu.float()).abs() > \
        PM.MOE_GOLDEN_TOL["bf16"][0] + 2 ** -7 * y_cpu.float().abs()
    if bool(bad.any()) or not torch.equal((y_dev == 0).all(-1), (y_cpu == 0).all(-1)):
        raise AssertionError(f"moe_ffn: card vs CPU on groups {groups}: max err {cpu_err}")

    for r, (y_ans, aux_ans) in zip(requests, answers):
        y, aux = model(torch.from_numpy(r).to(dev, torch.bfloat16))
        if not (np.array_equal(y_ans, y.float().cpu().numpy()) and aux_ans == float(aux)):
            raise AssertionError(f"served answer for {r.shape} differs from the direct call")
    res = {"golden": golden_res, "cpu_groups": groups, "cpu_y_err": cpu_err,
           "served_equal_direct": len(answers)}
    log(f"phase 7d checks: {json.dumps(res)}")
    return res


# ---------------------------------------------- phase 8: the sharded scheduler

SHARD_REPLACES = "ray_tpu/sched/kernel_shard.py:54-196"
# the shard count of the main path: the JAX tests' 8-device mesh
PATH_SHARDS = 8


def negative_problem():
    """A view with a negative entry and a round that places nothing
    (tests/test_torch_sched_kernel.py): K7 keeps the entry, as kernel_np."""
    N = 8
    total = np.zeros((N, R), np.float32)
    total[:, 0] = 4.0
    total[:, 3] = 16.0
    avail = total.copy()
    avail[:, 0] = 0.0
    avail[2, 3] = -3.0
    demands = np.zeros((2, R), np.float32)
    demands[0, 0] = 1.0
    demands[1, 0] = 2.0
    demands[1, 3] = 1.0
    return avail, total, np.ones(N, bool), demands, np.array([5, 3], np.int32)


def bench_shard_problem():
    """bench.py sharded_kernel_bench's problem: N 2048, C 32, seed 0."""
    rng = np.random.default_rng(0)
    N, C = 2048, 32
    total = np.zeros((N, R), np.float32)
    total[:, 0] = rng.integers(16, 65, N)
    total[:, 3] = rng.integers(64, 513, N)
    demands = np.zeros((C, R), np.float32)
    demands[:, 0] = rng.integers(1, 5, C)
    counts = rng.integers(0, 500, C).astype(np.int32)
    return total.copy(), total, np.ones(N, bool), demands, counts


def dryrun_shard_problem(n_devices=8):
    """__graft_entry__.dryrun_multichip's scheduler part: 16 nodes a
    device, 4 classes, seed 0."""
    rng = np.random.default_rng(0)
    n_nodes = 16 * n_devices
    total = np.zeros((n_nodes, R), np.float32)
    total[:, 0] = rng.integers(4, 33, n_nodes)
    demands = np.zeros((4, R), np.float32)
    demands[:, 0] = rng.integers(1, 4, 4)
    counts = rng.integers(0, 50, 4).astype(np.int32)
    return total.copy(), total, np.ones(n_nodes, bool), demands, counts


def stream_first_round():
    """The stream's first round (phase 1): 10k nodes, 20 % held back, 256
    classes, a tenth of the 1M tasks."""
    total, alive, demands, counts = build_stream_problem(np.random.default_rng(5))
    alive = alive.copy()
    alive[int(len(alive) * 0.8):] = False
    first = np.floor(counts / 10).astype(np.int32)
    return total * alive[:, None], total, alive, demands, first


def straddle_problem(N=8192):
    """tests/test_torch_sched_shard.py's straddle_problem: bucket 0 holds
    every node under the threshold (a cap of 3 each) and the first class's
    count ends inside it at a node past block 0 for p >= 2."""
    total = np.zeros((N, R), np.float32)
    total[:, 0] = 4.0
    total[:, 3] = 64.0
    alive = np.ones(N, bool)
    alive[3::101] = False
    avail = total.copy()
    avail[::7, 3] = 16.0
    avail *= alive[:, None]
    demands = np.zeros((2, R), np.float32)
    demands[0, 0] = 1.0
    demands[1, 0] = 1.0
    demands[1, 3] = 2.0
    return avail, total, alive, demands, np.array([3 * 5000 + 1, 6000], np.int32)


def phase8a_sharded_kernel(torch, KT, KS, kernel_np, dev, k1_bound):
    """K7 (K1's kernel on a cluster of p blocks) against its plain version,
    K1 and kernel_np on the card for every shard count, exactly
    (assignments and availability); then timed per shard count at the
    stream's first round in turns with K1 (K1, p = 1..8, p = 8..1, K1),
    each beside its cluster size, threads a block and row form."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    problems = [(f"random{s}", random_problem(s)) for s in (1, 2, 3)]
    problems += [("negative", negative_problem()), ("straddle", straddle_problem()),
                 ("stream_first_round", stream_first_round())]
    err = 0.0
    for name, (avail, total, alive, demands, counts) in problems:
        args = [T(x) for x in (avail, total, alive, demands, counts)]
        k1_a, k1_v = KT.schedule_classes(*args)
        np_a, np_v = kernel_np.schedule_classes(avail, total, alive, demands, counts)
        for p in KS.SHARDS:
            a_k, v_k = KS.schedule_classes_sharded(*args, shards=p)
            a_p, v_p = KS._schedule_classes_sharded_plain(*args, shards=p)
            for what, a, b in (("assigned", a_k, a_p), ("avail", v_k, v_p)):
                d = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
                err = max(err, d)
                if not torch.equal(a, b):
                    raise AssertionError(f"K7 {name} p={p}: {what} != plain (max abs err {d})")
            if not (torch.equal(a_k, k1_a) and torch.equal(v_k, k1_v)):
                raise AssertionError(f"K7 {name} p={p}: != K1")
            if not (np.array_equal(a_k.cpu().numpy(), np_a)
                    and np.array_equal(v_k.cpu().numpy(), np_v)):
                raise AssertionError(f"K7 {name} p={p}: != kernel_np")
        log(f"K7 {name}: N={len(total)} C={len(demands)} placed={int(k1_a.sum())}, "
            f"p = {KS.SHARDS} == plain == K1 == kernel_np")
    # timed at the stream's first round as K1 is in phase 1 (padded to the
    # class bucket); the launch without the wrapper's checks, which read
    # counts' maximum back to the host
    avail, total, alive, demands, counts = problems[-1][1]
    d_pad, k_pad = KT.pad_problem(demands, counts, KT.bucket_size(len(demands)))
    args = [T(x) for x in (avail, total, alive, d_pad, k_pad)]
    thr, passes = KT.DEFAULT_SPREAD_THRESHOLD, KT.MAX_PASSES
    k1_ms = [time_ms(torch, lambda: KT.schedule_classes(*args))]
    turns = {p: [] for p in KS.SHARDS}
    for order in (KS.SHARDS, KS.SHARDS[::-1]):
        for p in order:
            turns[p].append(time_ms(torch, lambda: KS._launch(*args, thr, passes, p)))
    k1_ms.append(time_ms(torch, lambda: KT.schedule_classes(*args)))
    ms = {p: float(np.mean(v)) for p, v in turns.items()}
    plain_ms = time_ms(torch, lambda: KS._schedule_classes_sharded_plain(
        *args, shards=PATH_SHARDS), reps=3, warm=1)
    N = len(total)
    for p in KS.SHARDS:
        plan = KT.k1_plan(N, R, p)
        log(f"  K7 p = {p}: a cluster of {plan.cluster} blocks of "
            f"{KS.k7_threads(N, R, p)} threads, "
            f"{plan.nodes_per_block} nodes a block, rows in "
            f"{'shared' if plan.rows_in_smem else 'global'} memory; {ms[p]:.4f} ms "
            f"({turns[p][0]:.4f} / {turns[p][1]:.4f} in turns)")
    rec = {"max_abs_err": err, "ms": ms[PATH_SHARDS], "plain_ms": plain_ms,
           "library_ms": None, "bound": k1_bound, "ms_by_shards": ms,
           "ms_in_turns": {str(p): v for p, v in turns.items()}, "k1_ms": k1_ms}
    log(f"  schedule_classes_sharded: {json.dumps({str(p): v for p, v in ms.items()})} ms "
        f"by shard count (K1 {k1_ms[0]:.4f} / {k1_ms[1]:.4f} ms before / after; plain "
        f"{plain_ms:.4f} ms at p = {PATH_SHARDS}; bound {k1_bound[0]:.4f} ms by "
        f"{k1_bound[1]})")
    return rec


def phase8b_sharded_path(torch, KT, KS, dev, max_rounds=30):
    """The main path: make_sharded_scheduler(8) on the card over bench.py's
    sharded_kernel_bench problem, dryrun_multichip's, and the stream
    problem's rounds with the availability carried from round to round
    (each round's counts 30 fewer, as test_sharded_carried_state_rounds
    carries them) until a round places nothing; every round's decisions and
    availability equal to K1's on the same state. Each round of both is
    timed with CUDA events."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    fn = KS.make_sharded_scheduler(PATH_SHARDS)
    res = {}
    for name, prob in (("bench", bench_shard_problem()), ("dryrun", dryrun_shard_problem())):
        a, v = fn(*prob)
        k1_a, k1_v = KT.schedule_classes(*[T(x) for x in prob])
        if not (torch.equal(a, k1_a) and torch.equal(v, k1_v)):
            raise AssertionError(f"sharded path {name}: != K1")
        res[name] = {"placed": int(a.sum())}
    avail, total, alive, demands, first = stream_first_round()
    total, alive, demands = T(total), T(alive), T(demands)
    av_sh = av_k1 = T(avail)
    rounds, placed, ms_sh, ms_k1 = 0, 0, 0.0, 0.0

    def timed(f):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = f()
        e.record()
        e.synchronize()
        return out, s.elapsed_time(e)

    for rnd in range(max_rounds):
        k = np.maximum(first - rnd * 30, 0).astype(np.int32)
        (a, av_sh), t_sh = timed(lambda: fn(av_sh, total, alive, demands, k))
        (k1_a, av_k1), t_k1 = timed(lambda: KT.schedule_classes(av_k1, total, alive,
                                                                demands, T(k)))
        if not (torch.equal(a, k1_a) and torch.equal(av_sh, av_k1)):
            raise AssertionError(f"sharded path, stream round {rnd}: != K1")
        rounds += 1
        ms_sh += t_sh
        ms_k1 += t_k1
        n = int(a.sum())
        placed += n
        if n == 0:
            break
    res["stream"] = {"rounds": rounds, "placed": placed, "ms_sharded": ms_sh, "ms_k1": ms_k1,
                     "decisions_per_s_sharded": placed / (ms_sh / 1e3),
                     "decisions_per_s_k1": placed / (ms_k1 / 1e3)}
    log(f"phase 8b sharded path: {json.dumps(res)}")
    return res


# ------------------------------------------------------------ phase 9: training

# the training path's kernels (the forward's three run there too)
TRAIN_KERNELS = ("attention", "rmsnorm", "rope_split", "attention_bwd", "rmsnorm_bwd",
                 "rope_split_bwd")
# launches a train step at the default config (6 layers, each block
# checkpointed): K8 6 forward + 6 recomputed; K8' 6; K10a 2 a block forward
# and recomputed, + ln_f; K10a' 2 a block + ln_f; K10b 6 + 6; K10b' 6
TRAIN_LAUNCHES_PER_STEP = {"attention": 12, "attention_bwd": 6, "rmsnorm": 25,
                           "rmsnorm_bwd": 13, "rope_split": 12, "rope_split_bwd": 6}
TRAIN_REPLACES = {
    "attention_bwd": "ray_tpu/parallel/tpu_train.py:78",
    "rmsnorm_bwd": "ray_tpu/parallel/tpu_train.py:78",
    "rope_split_bwd": "ray_tpu/parallel/tpu_train.py:78",
}
TRAIN_GOLDEN_PATH = os.path.join(HERE, "tests", "data", "train_golden.npz")
TRAIN_SEED = 0
TRAIN_STEPS = 10
ACTOR_STEPS = 4


def phase9a_train_kernels(torch, MK, dev, S=2048):
    """K8', K10a' and K10b' against their plain versions on the card at
    the train step's shapes (B 8, S 2048, H 8, Dh 64; rows 16 384 x 512),
    in bf16 and f32, each launched twice (the bits must agree; K10b' in
    its rows form, and its scalar form on offset views with the same
    bits); then timed
    in bf16 beside the plain versions, the bound and the backward of the
    library call where there is one (SDPA, rms_norm)."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(9)
    B, H, Dh = 8, 8, 64
    D = H * Dh
    rec = {name: {"max_abs_err": 0.0} for name in ("attention_bwd", "rmsnorm_bwd",
                                                   "rope_split_bwd")}
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev, dt)

    def check(name, got, want, again, what):
        # a gradient is a sum over up to 2 048 terms: its rounding follows
        # the largest entry, as block_update's state does
        rtol, atol = KERNEL_TOL["f32" if want.dtype == torch.float32 else "bf16"]
        atol = max(atol, rtol * float(want.abs().max()))
        gd, wd = got.double(), want.double()
        d = float((gd - wd).abs().max())
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], d)
        if bool(((gd - wd).abs() > atol + rtol * wd.abs()).any()) \
                or not bool(torch.isfinite(gd).all()):
            raise AssertionError(f"{name} {what}: kernel != plain (max abs err {d}, "
                                 f"tolerance rtol {rtol} atol {atol})")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {what}: two launches gave different bits")

    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = (rnd((B, S, H, Dh), dt) for _ in range(4))
        _, m, l = MK._attention_launch(q, k, v, True, True, stats=True)
        for part, a, b, c in zip("qkv", MK.attention_bwd(q, k, v, do, m, l),
                                 MK._attention_bwd_plain(q, k, v, do, m, l, True),
                                 MK.attention_bwd(q, k, v, do, m, l)):
            check("attention_bwd", a, b, c, f"{names[dt]} d{part}")
        x, dy, sc = rnd((B * S, D), dt, 3.0), rnd((B * S, D), dt), rnd((D,), torch.float32)
        for part, a, b, c in zip(("dx", "dscale"), MK.rmsnorm_bwd(x, sc, dy),
                                 MK._rmsnorm_bwd_plain(x, sc, dy), MK.rmsnorm_bwd(x, sc, dy)):
            check("rmsnorm_bwd", a, b, c, f"{names[dt]} {part}")
        dq, dk, dv = (rnd((B, S, H, Dh), dt) for _ in range(3))
        if MK.rope_split_bwd_form(dq, dk, dv) != "rows":
            raise AssertionError(f"rope_split_bwd {names[dt]}: not the rows form at the "
                                 "train step's shapes")
        got = MK.rope_split_bwd(dq, dk, dv, 1e4)
        check("rope_split_bwd", got, MK._rope_split_bwd_plain(dq, dk, dv, 1e4),
              MK.rope_split_bwd(dq, dk, dv, 1e4), names[dt])
        # the scalar form, on views one element into their storage: its bits
        shifted = []
        for t in (dq, dk, dv):
            view = torch.empty(t.numel() + 1, dtype=dt, device=dev)[1:].view(t.shape)
            view.copy_(t)
            shifted.append(view)
        if MK.rope_split_bwd_form(*shifted) != "scalar":
            raise AssertionError(f"rope_split_bwd {names[dt]}: an offset view not scalar")
        if not torch.equal(MK.rope_split_bwd(*shifted, 1e4), got):
            raise AssertionError(f"rope_split_bwd {names[dt]}: the rows form's bits are not "
                                 "the scalar form's")

    bf = torch.bfloat16
    q, k, v, do = (rnd((B, S, H, Dh), bf) for _ in range(4))
    _, m, l = MK._attention_launch(q, k, v, True, True, stats=True)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    _, m32, l32 = MK._attention_launch(q32, k32, v32, True, True, stats=True)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    pairs = S * (S + 1) // 2
    rec["attention_bwd"].update(
        ms=time_ms(torch, lambda: MK.attention_bwd(q, k, v, do, m, l)),
        ms_f32_cuda_core=time_ms(torch, lambda: MK.attention_bwd(q32, k32, v32, do32, m32,
                                                                 l32)),
        plain_ms=time_ms(torch, lambda: MK._attention_bwd_plain(q, k, v, do, m, l, True),
                         reps=3, warm=1),
        library_ms=time_ms(torch, lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot,
                                                              retain_graph=True)),
        # five causal products; q, k, v, dO read, dq, dk, dv written, m, l read
        bound=bound(7 * B * S * H * Dh * 2 + 2 * B * H * S * 4, 5 * 2 * B * H * Dh * pairs,
                    PEAK_BF16_OPS_PER_S))
    x, dy, sc = rnd((B * S, D), bf, 3.0), rnd((B * S, D), bf), rnd((D,), torch.float32)
    xl = x.clone().requires_grad_(True)
    scl = sc.to(bf).requires_grad_(True)
    y = F.rms_norm(xl, (D,), scl, 1e-6)
    rec["rmsnorm_bwd"].update(
        ms=time_ms(torch, lambda: MK.rmsnorm_bwd(x, sc, dy), reps=21),
        plain_ms=time_ms(torch, lambda: MK._rmsnorm_bwd_plain(x, sc, dy), reps=21),
        library_ms=time_ms(torch, lambda: torch.autograd.grad(y, (xl, scl), dy,
                                                              retain_graph=True), reps=21),
        bound=bound(3 * B * S * D * 2 + 2 * D * 4, 12 * B * S * D))
    dq, dk, dv = (rnd((B, S, H, Dh), bf) for _ in range(3))
    rec["rope_split_bwd"].update(
        ms=time_ms(torch, lambda: MK.rope_split_bwd(dq, dk, dv, 1e4), reps=21),
        plain_ms=time_ms(torch, lambda: MK._rope_split_bwd_plain(dq, dk, dv, 1e4), reps=21),
        library_ms=None,
        bound=bound(2 * B * S * 3 * D * 2, 6 * B * S * D))
    for name, r in rec.items():
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']} ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}), "
            f"max abs err {r['max_abs_err']:.3g}, two launches bit-equal")
    log(f"  attention_bwd f32 (CUDA cores): {rec['attention_bwd']['ms_f32_cuda_core']:.4f} ms")
    return rec


def _train_tokens(cfg, batch=8, seq=2048):
    rng = np.random.default_rng(90)
    return rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)


def phase9b_train(torch, PT, TT, dev, steps=TRAIN_STEPS, cfg=None, batch=8, seq=2048):
    """The training path, called directly: make_train_state (seed 0) and
    make_train_step at the default config in bf16, `steps` steps on one
    seeded [batch, seq + 1] batch; each step timed by CUDA events; the
    loss finite and lower after the last step than after the first. The
    losses and a parameter checksum after ACTOR_STEPS steps are kept for
    9c."""
    cfg = cfg or PT.TransformerConfig()
    params, opt_state, tx, shardings = TT.make_train_state(cfg, seed=TRAIN_SEED, device=dev)
    step, _ = TT.make_train_step(cfg, None, tx, shardings)
    tokens = _train_tokens(cfg, batch, seq)
    losses, ms = [], []
    checksum = None
    for i in range(steps):
        if dev.type == "cuda":
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
        _, _, loss = step(params, opt_state, {"tokens": tokens})
        if dev.type == "cuda":
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
        losses.append(float(loss))
        if i + 1 == ACTOR_STEPS:
            checksum = PT.weights_checksum(PT.to_numpy(params))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training: losses {losses} not finite or not falling")
    step_ms = float(np.median(ms[1:])) if ms else float("nan")
    res = {"batch": batch, "seq": seq, "steps": steps, "first_loss": losses[0],
           "last_loss": losses[-1], "step_ms_median": step_ms,
           "first_step_ms": ms[0] if ms else float("nan"),
           "tokens_per_s": batch * seq / (step_ms / 1e3),
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30
           if dev.type == "cuda" else float("nan")}
    log(f"phase 9b train: {json.dumps(res)}")
    return res, {"cfg": cfg, "tokens": tokens, "losses": losses, "checksum": checksum,
                 "dev": dev}


def phase9c_train_actor(torch, PT, TT, ctx, steps=ACTOR_STEPS):
    """The training path from an actor of ray_tpu_torch.init() (default
    config: the torch_cuda policy on the card) that owns the train state
    from the same seed and takes `steps` steps on the batches sent to it:
    its losses and parameter checksum must equal the direct run's bit for
    bit."""
    import ray_tpu_torch as rt

    cfg, dev, tokens = ctx["cfg"], ctx["dev"], ctx["tokens"]
    if dev.type == "cuda":
        rt.init(num_cpus=8)
    else:
        rt.init(num_cpus=8, _system_config={"scheduler_device": "cpu"})
    try:
        @rt.remote
        class Trainer:
            """User code: owns the train state on the card, steps on request."""

            def __init__(self, seed):
                self.params, self.opt_state, tx, sh = TT.make_train_state(cfg, seed=seed,
                                                                          device=dev)
                self.step_fn, _ = TT.make_train_step(cfg, None, tx, sh)

            def step(self, batch):
                _, _, loss = self.step_fn(self.params, self.opt_state, batch)
                return float(loss)

            def checksum(self):
                return PT.weights_checksum(PT.to_numpy(self.params))

        trainer = Trainer.remote(TRAIN_SEED)
        t0 = time.perf_counter()
        losses = [rt.get(trainer.step.remote({"tokens": tokens}), timeout=600)
                  for _ in range(steps)]
        t_train = time.perf_counter() - t0
        checksum = rt.get(trainer.checksum.remote(), timeout=600)
    finally:
        rt.shutdown()
    if losses != ctx["losses"][:steps] or checksum != ctx["checksum"]:
        raise AssertionError(f"actor's training differs from the direct run: losses {losses} "
                             f"vs {ctx['losses'][:steps]}, checksum {checksum[:16]} vs "
                             f"{ctx['checksum'][:16]}")
    res = {"steps": steps, "losses_equal_direct": True, "checksum_equal_direct": True,
           "actor_s": t_train}
    log(f"phase 9c actor training: {json.dumps(res)}")
    return res


def phase9d_train_checks(torch, PT, TT, dev):
    """One step's loss, gradient norms, sampled gradients and sampled
    post-AdamW parameters, and the second step's loss, in both dtypes,
    against tests/data/train_golden.npz within TRAIN_GOLDEN_TOL."""
    golden = np.load(TRAIN_GOLDEN_PATH)
    if PT.weights_checksum(PT.numpy_params(PT.TransformerConfig(), int(golden["weight_seed"]))) \
            != str(golden["checksum"]):
        raise AssertionError("numpy_params gave other weights than the train golden's")
    res = {}
    for dt in ("f32", "bf16"):
        res[dt] = TT.train_golden_errors(golden, dt, dev)
        bad = TT.train_golden_violations(res[dt], dt)
        if bad:
            raise AssertionError(f"train golden {dt}: {bad} outside {TT.TRAIN_GOLDEN_TOL[dt]}")
    log(f"phase 9d train golden: {json.dumps(res)}")
    return res


# ---------------------------------------------- phase 10: the expert layer's training

# the gradient of moe_ffn, which K9a'-c' replace: its reference path is
# tests/test_parallel.py:179 test_moe_grads_flow
MOE_BWD_REPLACES = "ray_tpu/models/moe.py:57-116"
MOE_GRAD_GOLDEN_PATH = os.path.join(HERE, "tests", "data", "moe_grad_golden.npz")
MOE_TRAIN_STEPS = 10  # direct: step 1 warms up, 2-7 timed; 8-10 profiled apart
MOE_EVENT_STEPS = 7
MOE_ACTOR_STEPS = 4
# the expert kernels one train step launches once each (K9c' in its one-launch form)
MOE_STEP_KERNELS = ("route_kernel", "dispatch_kernel", "combine_kernel", "route_bwd_kernel",
                    "dispatch_bwd_kernel", "combine_bwd_fused_kernel")
MOE_LR, MOE_WD = 3e-4, 0.01


def _moe_loss(y, aux):
    """tests/test_parallel.py::test_moe_grads_flow's loss."""
    return (y.float() ** 2).mean() + 0.01 * aux


def phase10a_moe_bwd_kernels(torch, PM, EK, dev):
    """K9a', K9b' and K9c' against their plain versions on the card at the
    main path's shapes (logits [8, 2048, 8], C 320, rows of 256) in f32 and
    bf16, each launched twice (the bits must agree): the gathers bit-equal,
    d_logits and d_gate within BWD_TOL of their largest entry, K9c' in its
    one-launch form, K9a' also at 3, 9, 16, 33 and 64 experts with ties
    (every layout of its lanes);
    then timed as the train step calls them (bf16 tokens and experts) beside
    the bound and the gather alone (index_select)."""
    cfg, tree, _, x32 = _moe_layer(torch, PM, dev)
    G, S, D = MOE_SHAPE
    E, C = cfg.n_experts, PM._capacity(cfg, S)
    logits = torch.matmul(x32, torch.from_numpy(tree["router"]).to(dev))
    _, gate, slot, tos, stats = EK.moe_route(logits, C)
    frac = EK.aux_loss(stats, G * S)[0]
    gen = torch.Generator(dev).manual_seed(10)
    rec = {name: {"max_abs_err": 0.0}
           for name in ("moe_route_bwd", "moe_dispatch_bwd", "moe_combine_bwd")}

    def close(name, got, want, again, what):
        d = float((got.double() - want.double()).abs().max())
        scale = float(want.double().abs().max()) or 1.0
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], d)
        if d > EK.BWD_TOL * scale or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {what}: kernel != plain (max abs err {d}, largest "
                                 f"entry {scale}, tolerance {EK.BWD_TOL} of it)")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {what}: two launches gave different bits")

    def equal(name, got, want, again, what):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: kernel != plain")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {what}: two launches gave different bits")

    d_gate = torch.randn((G, S), generator=gen, device=dev)
    d_aux = torch.full((), 0.01, device=dev)
    close("moe_route_bwd", EK.moe_route_bwd(logits, d_gate, frac, d_aux),
          EK._route_bwd_plain(logits, d_gate, frac, d_aux),
          EK.moe_route_bwd(logits, d_gate, frac, d_aux), "main path")
    # K9a''s other layouts (lanes past E idle, 16 and 32 lanes a token, one
    # warp a token with two experts a lane), with two experts tied at the max
    # on every 7th token
    for E2 in (3, 9, 16, 33, 64):
        lt = torch.randn((G, S, E2), generator=gen, device=dev) * 2
        lt[:, ::7, 0] = lt[:, ::7, E2 - 1] = 6.0
        fr = torch.rand((E2,), generator=gen, device=dev)
        close("moe_route_bwd", EK.moe_route_bwd(lt, d_gate, fr, d_aux),
              EK._route_bwd_plain(lt, d_gate, fr, d_aux),
              EK.moe_route_bwd(lt, d_gate, fr, d_aux), f"E={E2}")
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    out = torch.randn((E, G, C, D), generator=gen, device=dev)
    for a_name, a_dt in dt.items():
        d_in = torch.randn((E, G, C, D), generator=gen, device=dev).to(a_dt)
        for b_name, b_dt in dt.items():
            equal("moe_dispatch_bwd", EK.moe_dispatch_bwd(d_in, slot, b_dt),
                  EK._dispatch_bwd_plain(d_in, slot, b_dt), EK.moe_dispatch_bwd(d_in, slot, b_dt),
                  f"{a_name} -> {b_name}")
        dy = torch.randn((G, S, D), generator=gen, device=dev).to(a_dt)
        if not EK.combine_bwd_one_launch(dy, out):
            raise AssertionError("moe_combine_bwd: not one launch at the main path's shapes")
        got, want, again = (f(dy, out, slot, gate, tos) for f in (
            EK.moe_combine_bwd, EK._combine_bwd_plain, EK.moe_combine_bwd))
        equal("moe_combine_bwd", got[0], want[0], again[0], f"dy {a_name}: d_out")
        close("moe_combine_bwd", got[1], want[1], again[1], f"dy {a_name}: d_gate")
        if not bool((got[1][slot < 0] == 0).all()):
            raise AssertionError("moe_combine_bwd: a dropped token has a gate gradient")

    bf = torch.bfloat16
    kept = int((slot >= 0).sum())
    d_in, dy = (t.to(bf) for t in (out, torch.randn((G, S, D), generator=gen, device=dev)))
    rec["moe_route_bwd"].update(
        ms=time_ms(torch, lambda: EK.moe_route_bwd(logits, d_gate, frac, d_aux), reps=21),
        plain_ms=time_ms(torch, lambda: EK._route_bwd_plain(logits, d_gate, frac, d_aux),
                         reps=21),
        library_ms=None,
        # logits, d_gate, frac_tokens, d_aux read, d_logits written; a token:
        # ~17 operations an expert (the softmax again, the tie split, the
        # aux term, the softmax's backward)
        bound=bound(2 * G * S * E * 4 + G * S * 4 + E * 4 + 4, 17 * G * S * E))
    # the gathers alone as the library yardsticks: the same rows in one
    # index_select (no cast, no gate, no zero fill)
    src = torch.where(slot >= 0, (slot // C * G + torch.arange(G, device=dev)[:, None]) * C
                      + slot % C, 0).reshape(-1).long()
    d_in_flat = d_in.reshape(E * G * C, D)
    rec["moe_dispatch_bwd"].update(
        ms=time_ms(torch, lambda: EK.moe_dispatch_bwd(d_in, slot, bf), reps=21),
        plain_ms=time_ms(torch, lambda: EK._dispatch_bwd_plain(d_in, slot, bf), reps=21),
        library_ms=time_ms(torch, lambda: torch.index_select(d_in_flat, 0, src), reps=21),
        # slot read, the kept slots' rows read, dx written
        bound=bound(G * S * 4 + kept * D * 2 + G * S * D * 2, 0))
    if not EK.combine_bwd_one_launch(dy, out):
        raise AssertionError("moe_combine_bwd: not one launch at the main path's shapes")
    dy_flat = dy.reshape(G * S, D)
    rows = (torch.arange(G, device=dev)[None, :, None] * S + tos.clamp_min(0)).reshape(-1)
    rec["moe_combine_bwd"].update(
        ms=time_ms(torch, lambda: EK.moe_combine_bwd(dy, out, slot, gate, tos), reps=21),
        plain_ms=time_ms(torch, lambda: EK._combine_bwd_plain(dy, out, slot, gate, tos),
                         reps=21),
        library_ms=time_ms(torch, lambda: torch.index_select(dy_flat, 0, rows), reps=21),
        # token_of_slot, slot and gate read, the kept tokens' rows of dy and
        # of out read, d_out and d_gate written; a kept row: D products for
        # d_out, D products and sums for d_gate
        bound=bound(E * G * C * 4 + 2 * G * S * 4 + kept * D * (2 + 4)
                    + E * G * C * D * 4 + G * S * 4, 3 * kept * D))
    for name, r in rec.items():
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, gather alone "
            f"{r['library_ms']} ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}), "
            f"max abs err {r['max_abs_err']:.3g}, two launches bit-equal")
    return rec


def _busy_share(torch, fn, steps, each_step, windows=3):
    """The device's busy share of a window of `steps` calls of fn() under
    torch.profiler: kernel time over the window's host time. A window
    counts only if the profiler recorded every kernel named in `each_step`
    (CUDA symbols) once a call: one that lost device records would read
    low, or 0. Up to `windows` windows are taken, the first complete one is
    the answer, and none complete raises."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.scripts.profile_model import device_ms_by_kernel

    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        names = [ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA]
        seen = {k: sum(1 for n in names if re.search(rf"\b{k}\b", n)) for k in each_step}
        if all(n == steps for n in seen.values()):
            return sum(device_ms_by_kernel(prof).values()) / window_ms
        log(f"  busy share: torch.profiler recorded {seen} of the port's kernels in {steps} "
            f"calls (of {len(names)} device events), not {steps} each; another window")
    raise RuntimeError(f"torch.profiler lost some of the port's kernels in each of {windows} "
                       f"windows of {steps} calls")


def _moe_train_step(torch, PM, model, x, tx, state):
    """One training step of the layer, written out: the gradients cleared,
    the reference test's loss, its backward, AdamW. x requires a gradient
    (the one the layer below would take), so the step runs K9b' too."""
    model.zero_grad(set_to_none=True)
    x.grad = None
    y, aux = PM.moe_ffn(model, x)
    loss = _moe_loss(y, aux)
    loss.backward()
    tx.update(model, state)
    return loss.detach()


def _moe_train_setup(torch, PM, TT, dev):
    """Phase 10b's layer (the main path's weights, requires_grad on), its
    tokens x [8, 2048, 256] bf16 requiring a gradient, AdamW and its state."""
    cfg, tree, _, x32 = _moe_layer(torch, PM, dev)
    model = PM.moe_params_from_numpy(tree, cfg, device=dev).requires_grad_(True)
    x = x32.to(torch.bfloat16).requires_grad_(True)
    tx = TT.make_optimizer(MOE_LR, MOE_WD)
    return cfg, tree, x32, model, x, tx, tx.init(model)


def phase10b_moe_train(torch, PM, TT, dev, steps=MOE_TRAIN_STEPS):
    """The expert layer's training path, called directly: the layer from
    the main path's weights with requires_grad on, make_optimizer(3e-4,
    0.01), `steps` steps on x [8, 2048, 256] bf16 (skew 1.0): step 1 warms
    up, 2-7 are timed by CUDA events and by the host clock. The device's
    busy share over steps 8-10 comes from a process of its own that takes
    the same steps (moe_busy_share_child): in this process torch.profiler
    has gone minutes without a session and loses device records (PERF.md).
    The loss must be finite and fall. The losses and a parameter checksum
    after MOE_ACTOR_STEPS steps are kept for 10c."""
    cfg, tree, x32, model, x, tx, state = _moe_train_setup(torch, PM, TT, dev)
    cuda = dev.type == "cuda"
    losses, ms, wall = [], [], []
    checksum = None
    for i in range(steps):  # step 1 warms up, then the timed ones
        timed = cuda and i < MOE_EVENT_STEPS
        if timed:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            sync(torch, dev)
            t0 = time.perf_counter()
            s.record()
        loss = _moe_train_step(torch, PM, model, x, tx, state)
        if timed:
            e.record()
            e.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            ms.append(s.elapsed_time(e))
        losses.append(float(loss))
        if i + 1 == MOE_ACTOR_STEPS:
            checksum = PM.moe_weights_checksum(PM.moe_to_numpy(model))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"expert training: losses {losses} not finite or not falling")
    busy = moe_busy_share_child() if cuda else float("nan")
    G, S, _ = MOE_SHAPE
    step_ms = float(np.median(ms[1:])) if cuda else float("nan")
    wall_ms = float(np.median(wall[1:])) if cuda else float("nan")
    res = {"shape": list(MOE_SHAPE), "steps": steps, "first_loss": losses[0],
           "last_loss": losses[-1], "step_ms_median": step_ms,
           "first_step_ms": ms[0] if ms else float("nan"), "wall_ms_median": wall_ms,
           "tokens_per_s": G * S / (step_ms / 1e3), "tokens_per_s_host": G * S / (wall_ms / 1e3),
           "device_busy_share": busy,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda
           else float("nan")}
    log(f"phase 10b expert training: {json.dumps(res)}")
    return res, {"cfg": cfg, "tree": tree, "x32": x32, "x": x, "losses": losses,
                 "checksum": checksum, "dev": dev}


BUSY_SHARE_ARG = "--moe-busy-share"


def moe_busy_share_child() -> float:
    """Phase 10b's busy share, taken by this script run with BUSY_SHARE_ARG
    in a process of its own (moe_busy_share_main)."""
    res = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"), BUSY_SHARE_ARG],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"the busy-share process failed ({res.returncode}): "
                           f"{res.stderr[-2000:]}")
    return float(json.loads(res.stdout.strip().splitlines()[-1])["device_busy_share"])


def moe_busy_share_main(torch, PM, TT) -> int:
    """Steps 1-7 of phase 10b, then the device's busy share over steps 8-10
    under torch.profiler, every expert kernel recorded once a step (where a
    window lost records, over the next three steps, twice at most, or this
    raises); prints it as the last line."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _, _, _, model, x, tx, state = _moe_train_setup(torch, PM, TT, dev)
    for _ in range(MOE_EVENT_STEPS):
        _moe_train_step(torch, PM, model, x, tx, state)
    busy = _busy_share(torch, lambda: _moe_train_step(torch, PM, model, x, tx, state),
                       MOE_TRAIN_STEPS - MOE_EVENT_STEPS, MOE_STEP_KERNELS)
    print(json.dumps({"device_busy_share": busy}), flush=True)
    return 0


def phase10c_moe_train_actor(torch, PM, TT, ctx, steps=MOE_ACTOR_STEPS):
    """The expert layer's training from an actor of ray_tpu_torch.init()
    (default config: the torch_cuda policy on the card) that owns a layer
    built from the same weights and takes `steps` steps on the tokens sent
    to it: its losses and parameter checksum must equal the direct run's
    bit for bit."""
    import ray_tpu_torch as rt

    cfg, tree, dev = ctx["cfg"], ctx["tree"], ctx["dev"]
    tokens = ctx["x32"].cpu().numpy()
    if dev.type == "cuda":
        rt.init(num_cpus=8)
    else:
        rt.init(num_cpus=8, _system_config={"scheduler_device": "cpu"})
    try:
        @rt.remote
        class ExpertTrainer:
            """User code: owns the expert layer and its optimizer on the card."""

            def __init__(self, weights):
                self.layer = PM.moe_params_from_numpy(weights, cfg, device=dev)
                self.layer.requires_grad_(True)
                self.tx = TT.make_optimizer(MOE_LR, MOE_WD)
                self.state = self.tx.init(self.layer)

            def step(self, x):
                x = torch.from_numpy(x).to(dev, torch.bfloat16).requires_grad_(True)
                return float(_moe_train_step(torch, PM, self.layer, x, self.tx, self.state))

            def checksum(self):
                return PM.moe_weights_checksum(PM.moe_to_numpy(self.layer))

        trainer = ExpertTrainer.remote(tree)
        t0 = time.perf_counter()
        losses = [rt.get(trainer.step.remote(tokens), timeout=600) for _ in range(steps)]
        t_train = time.perf_counter() - t0
        checksum = rt.get(trainer.checksum.remote(), timeout=600)
    finally:
        rt.shutdown()
    if losses != ctx["losses"][:steps] or checksum != ctx["checksum"]:
        raise AssertionError(f"actor's expert training differs from the direct run: losses "
                             f"{losses} vs {ctx['losses'][:steps]}, checksum {checksum[:16]} "
                             f"vs {ctx['checksum'][:16]}")
    res = {"steps": steps, "losses_equal_direct": True, "checksum_equal_direct": True,
           "actor_s": t_train}
    log(f"phase 10c actor expert training: {json.dumps(res)}")
    return res


def phase10d_moe_train_checks(torch, PM, EK, ctx):
    """One training step in both expert dtypes against the JAX package's
    golden (tests/data/moe_grad_golden.npz) within MOE_GRAD_GOLDEN_TOL;
    then two groups of 10b's tokens free of near-ties, one step on the card
    against the plain step on the CPU (the loss within the bf16 golden's
    bound, each gradient leaf within one bf16 ulp, 2**-7, of its largest
    entry)."""
    dev = ctx["dev"]
    golden = np.load(MOE_GRAD_GOLDEN_PATH)
    cfg, tree = ctx["cfg"], ctx["tree"]
    if PM.moe_weights_checksum(PM.numpy_moe_params(cfg, int(golden["weight_seed"]))) \
            != str(golden["checksum"]):
        raise AssertionError("numpy_moe_params gave other weights than the grad golden's")
    # a weight's gradient sums over every group, so no group can be left
    # out: the golden's groups must all be free of near-ties
    left_out = int((golden["group_gap"] < PM.MOE_TIE_GAP).sum())
    if left_out:
        raise AssertionError(f"{left_out} golden groups hold a near-tie")
    res = {"groups_left_out": left_out}
    for dt in ("f32", "bf16"):
        res[dt] = PM.moe_grad_golden_errors(golden, dt, dev)
        bad = PM.moe_grad_golden_violations(res[dt], dt)
        if bad:
            raise AssertionError(f"moe grad golden {dt}: {bad} outside "
                                 f"{PM.MOE_GRAD_GOLDEN_TOL[dt]}")

    x32 = ctx["x32"]
    probs = EK.softmax_plain(torch.matmul(x32, torch.from_numpy(tree["router"]).to(dev))).cpu()
    top2 = probs.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).amin(-1)
    groups = [int(g) for g in torch.nonzero(gaps >= PM.MOE_TIE_GAP).flatten()[:2]]
    if len(groups) < 2:
        raise AssertionError(f"fewer than two groups of 10b free of near-ties: {gaps.tolist()}")
    grads, losses = [], []
    for d in (dev, torch.device("cpu")):
        model = PM.moe_params_from_numpy(tree, cfg, device=d).requires_grad_(True)
        x = x32[groups].to(d, torch.bfloat16).requires_grad_(True)
        y, aux = PM.moe_ffn(model, x)
        loss = _moe_loss(y, aux)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append(dict(PM.moe_grads_to_numpy(model), x=x.grad.float().cpu().numpy()))
    # each leaf within one bf16 ulp of its largest entry (2**-7 of it): the
    # cotangents of the bf16 products and dx round to bf16, and a sum taken
    # in another order (cuBLAS against the CPU) can land on the other side
    # of a rounding, which moves the entry by one ulp (measured on the H100:
    # x 4.9e-3, w1 3.3e-3, w2 1.7e-3, the router 5.1e-6)
    cpu_err = {"loss": abs(losses[0] - losses[1])}
    for name, want in grads[1].items():
        cpu_err[name] = float(np.abs(grads[0][name] - want).max() / np.abs(want).max())
    if cpu_err["loss"] > PM.MOE_GRAD_GOLDEN_TOL["bf16"]["loss"] \
            or any(cpu_err[name] > 2.0 ** -7 for name in grads[1]):
        raise AssertionError(f"expert training: card vs CPU on groups {groups}: {cpu_err} "
                             f"(loss {PM.MOE_GRAD_GOLDEN_TOL['bf16']['loss']}, leaves 2**-7 "
                             "of their largest entry)")
    res.update(cpu_groups=groups, cpu=cpu_err)
    log(f"phase 10d expert training checks: {json.dumps(res)}")
    return res


# ---------------------------------------------- phase 11: the paths across ranks

PHASE11_RANKS = 4
# phase 11's times are those of 4 processes sharing one card, their
# collectives staged through the host by gloo: never times across cards
PHASE11_TIMES_KEY = "ms_4_processes_on_one_H100_over_gloo"
PHASE11_DEADLINE_S = 300
K7R_REPLACES = "ray_tpu/sched/kernel_shard.py:54-131"
K7R_ROUNDS = 15  # the stream's first round, carried as phase 8b carries it
RING_SHAPE = (8, 2048, 8, 64)  # the flagship's attention, [B, S, H, Dh]
RING_SEED = 110
PIPE_D, PIPE_M, PIPE_MB = 512, 8, (2, 2048)  # d_model, microbatches, [B_m, S]
PIPE_SEED = 111


def _digest(*tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.cpu().numpy() if hasattr(t, "cpu") else t).tobytes())
    return h.hexdigest()


def _k7r_problems():
    return {"bench": bench_shard_problem(), "dryrun": dryrun_shard_problem(4),
            "negative": negative_problem()}


def _stream_round_counts(first, rnd):
    return np.maximum(first - rnd * 30, 0).astype(np.int32)


def _ring_inputs(torch, dev, shape=RING_SHAPE):
    rng = np.random.default_rng(RING_SEED)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
            for _ in range(3)]


def _pipe_inputs(torch, dev):
    rng = np.random.default_rng(PIPE_SEED)
    w = rng.standard_normal((PHASE11_RANKS, PIPE_D, PIPE_D), dtype=np.float32)
    x = rng.standard_normal((PIPE_M, *PIPE_MB, PIPE_D), dtype=np.float32)
    return (torch.from_numpy(w / np.float32(np.sqrt(PIPE_D))).to(dev),
            torch.from_numpy(x).to(dev))


def _pipe_stage(w, x):
    return (x @ w).tanh()


def _phase11_rank(rank, world, tmp, device_type, ring_shape):
    """One of phase 11's ranks on the one card (or the CPU, to rehearse):
    every path across ranks, its launch counters from 0 over them, then
    its results into tmp."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from ray_tpu_torch.models import kernels as MK, moe as PM, moe_kernels as EK
    from ray_tpu_torch.parallel import make_mesh, pipeline_apply, ulysses_attention
    from ray_tpu_torch.parallel.ring_attention import ring_attention
    from ray_tpu_torch.sched import kernel_shard as KS

    if device_type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device("cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        sync_ = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (lambda: None)
        g2 = dist.new_group([0, 1])  # every rank makes every group, in one order
        mesh_sp = make_mesh(("sp",), device=dev)
        mesh_pp = make_mesh(("pp",), device=dev)
        meshes_ep = {f"{dp}x{ep}": make_mesh(("dp", "ep"), shape=(dp, ep), device=dev)
                     for dp, ep in ((1, 4), (2, 2))}
        # inputs, made before the window
        q, k, v = _ring_inputs(torch, dev, ring_shape)
        Sb = ring_shape[1] // world
        blk = slice(rank * Sb, (rank + 1) * Sb)
        qkv = {dt: [x[:, blk].to(dt).contiguous() for x in (q, k, v)]
               for dt in (torch.bfloat16, torch.float32)}
        cfg, tree, _, x32 = _moe_layer(torch, PM, dev)
        moe = {}
        for tag, mesh in meshes_ep.items():
            Gl = MOE_SHAPE[0] // mesh.shape["dp"]
            d = mesh.axis_index("dp")
            moe[tag] = (PM.shard_moe_params(tree, cfg, mesh),
                        x32[d * Gl:(d + 1) * Gl].to(torch.bfloat16).contiguous())
        w, xs = _pipe_inputs(torch, dev)
        stream = stream_first_round()
        out, times, digests = {}, {}, {}

        def timed(name, fn):
            sync_()
            t = time.perf_counter()
            r = fn()
            sync_()
            times[name] = (time.perf_counter() - t) * 1e3
            return r

        dist.barrier()
        KS.reset_launch_counts()
        MK.reset_launch_counts()
        EK.reset_launch_counts()
        t_window = time.perf_counter()
        # K7r: the sharded scheduler over ranks 0-1, then over all four
        for p, group in ((2, g2), (4, dist.group.WORLD)):
            if rank >= p:
                continue
            fn = KS.make_sharded_scheduler(group, device=dev)
            for name, prob in _k7r_problems().items():
                a_k, v_k = timed(f"k7r p={p} {name}", lambda: fn(*prob))
                out[f"k7r_{p}_{name}_a"], out[f"k7r_{p}_{name}_v"] = (a_k.cpu().numpy(),
                                                                     v_k.cpu().numpy())
            avail, total, alive, demands, first = stream
            total, alive, demands = T(total), T(alive), T(demands)
            av = T(avail)
            t = time.perf_counter()
            for rnd in range(K7R_ROUNDS):
                a_k, av = fn(av, total, alive, demands, T(_stream_round_counts(first, rnd)))
                digests[f"{p}/stream{rnd}"] = _digest(a_k, av)
            times[f"k7r p={p} stream {K7R_ROUNDS} rounds"] = (time.perf_counter() - t) * 1e3
        dist.barrier()
        k7r_launches = KS.launch_counts()["rank_pass"]
        # ring attention over sp = 4, bf16 then float32
        for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            out[f"ring_{name}"] = timed(f"ring {name}", lambda: ring_attention(
                *qkv[dt], mesh_sp, causal=True)).float().cpu().numpy()
        ring_launches = dict(launches=MK.block_update.launches,
                             launches_tc=MK.block_update.launches_tc)
        out["ulysses_bf16"] = timed("ulysses bf16", lambda: ulysses_attention(
            *qkv[torch.bfloat16], mesh_sp, causal=True)).float().cpu().numpy()
        for tag, (local, xb) in moe.items():
            y, aux = timed(f"moe {tag}", lambda: PM.moe_ffn(local, xb, cfg,
                                                            mesh=meshes_ep[tag]))
            out[f"moe_y_{tag}"], out[f"moe_aux_{tag}"] = y.float().cpu().numpy(), float(aux)
        out["pipe"] = timed("pipeline", lambda: pipeline_apply(
            _pipe_stage, w, xs, mesh_pp)).cpu().numpy()
        window_s = time.perf_counter() - t_window
        launches = {**KS.launch_counts(), **MK.launch_counts(), **EK.launch_counts()}
        # after the window: each rank's routing of its dp block, for the check
        for tag, (local, xb) in moe.items():
            logits = torch.matmul(xb.float(), local.router)
            route = EK.moe_route(logits, PM._capacity(cfg, MOE_SHAPE[1]))
            out[f"moe_expert_{tag}"], out[f"moe_slot_{tag}"] = (route[0].cpu().numpy(),
                                                                route[2].cpu().numpy())
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump({"times": times, "digests": digests, "launches": launches,
                       "k7r_launches": k7r_launches, "ring": ring_launches,
                       "window_s": window_s}, f)
    finally:
        dist.destroy_process_group()


def _k7r_against_plain(torch, KS, KT, prob, dev):
    """K7r on the card, every step against its plain version on the CPU
    from the same state, pass after pass, over one shard of `prob`
    (_rank_loop, K7r's host loop); raises on any difference of a step's
    output or of the round's results. Returns (0.0, the passes run)."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    avail, total, alive, demands, counts = prob
    cpu = torch.device("cpu")
    states = [KS.RankRound(T(avail)[None].to(d), T(total)[None].to(d), T(alive)[None].to(d),
                           T(demands).to(d), KT.DEFAULT_SPREAD_THRESHOLD) for d in (dev, cpu)]

    def step(mode, c, all_tot=None, **kw):  # every state gets its tensors on its device
        got, want = (KS.rank_pass(mode, st, c, shard_index=[0], **kw, all_tot=None if all_tot
                                  is None else all_tot.to(st.dev)) for st in states)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"K7r mode {mode} class {c} {kw}: {got.cpu().tolist()} != "
                                 f"plain {want.tolist()}")
        return want

    trace = []
    KS._rank_loop(step, counts, KT.MAX_PASSES, lambda x: x.sum(dim=0).tolist(), lambda t: t,
                  trace)
    for a, b in ((states[0].assigned, states[1].assigned), (states[0].avail, states[1].avail)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("K7r round != plain")
    return 0.0, len(trace)


def _k7r_record(torch, KS, KT, dev):
    """K7r against its plain version, step by step, over rank 0's block of
    the stream's first round at p = 4 (2 500 nodes, one shard), then each
    step timed on the card there, in its first pass, beside the plain
    versions on the card; the bound of one pass (bytes: the block's rows
    read, avail written, the class's row of assigned)."""
    avail, total, alive, demands, counts = stream_first_round()
    Nl = len(total) // PHASE11_RANKS
    block = (avail[:Nl], total[:Nl], alive[:Nl], demands, counts)
    err, passes = _k7r_against_plain(torch, KS, KT, block, dev)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    st = KS.RankRound(T(block[0])[None], T(block[1])[None], T(block[2])[None], T(demands),
                      KT.DEFAULT_SPREAD_THRESHOLD)
    c = int(np.flatnonzero(counts > 0)[0])
    rem = int(counts[c])
    n_feas = int(KS.rank_pass(KS.TERMS, st, c, refresh=True)[0, 1])
    tot = KS.rank_pass(KS.CAPS, st, c, remaining=rem, n_feasible=n_feas)
    steps = {
        "terms": lambda: KS.rank_pass(KS.TERMS, st, c),
        "caps": lambda: KS.rank_pass(KS.CAPS, st, c, remaining=rem, n_feasible=n_feas),
        "fill": lambda: KS.rank_pass(KS.FILL, st, c, nc=c + 1, remaining=rem, all_tot=tot,
                                     shard_index=[0], more=True),
    }
    plain = {
        "terms": lambda: KS._terms_plain(st, c),
        "caps": lambda: KS._caps_plain(st, rem, n_feas),
        "fill": lambda: KS._fill_plain(st, c, c + 1, rem, tot, [0], True),
    }
    ms = {name: time_ms(torch, fn, reps=21) for name, fn in steps.items()}
    # the plain steps in order: caps reads what terms left, fill what caps left
    plain_ms = {name: time_ms(torch, fn, reps=7) for name, fn in plain.items()}
    R_ = total.shape[1]
    rec = {"max_abs_err": err, "ms": sum(ms.values()), "ms_by_step": ms,
           "plain_ms": sum(plain_ms.values()), "plain_ms_by_step": plain_ms,
           "library_ms": None, "passes_checked": passes,
           "bound": bound(3 * Nl * R_ * 4 + Nl + Nl * 4, 0)}
    log(f"  K7r against plain, step by step over {passes} passes of a {Nl}-node block: "
        f"equal; one pass {rec['ms']:.4f} ms ({json.dumps(ms)}), plain "
        f"{rec['plain_ms']:.4f} ms, bound {rec['bound'][0]:.6f} ms by bytes")
    return rec


def phase11_ranks(torch, KT, KS, MK, PM, EK, kernel_np, dev, ring_shape=RING_SHAPE):
    """The paths across ranks: 4 processes on the one card in one gloo
    group over CUDA tensors, spawned once (the kernels built by this
    process before); each runs K7r (the sharded scheduler over ranks 0-1
    and over all four: bench.py's, dryrun_multichip's and the negative
    problem, and the stream's first round carried 15 rounds), ring
    attention and Ulysses over sp = 4 on the flagship's q, k, v [8, 2048,
    8, 64], the expert layer over dp x ep = 1 x 4 and 2 x 2 on MoEConfig()
    with x [8, 2048, 256] bf16, and 4 pipeline stages of tanh(x @ w) at d
    512 over 8 microbatches [2, 2048, 512]; then this process checks what
    they gave against K1 and kernel_np (exactly), ring_schedule (bit for
    bit) and whole attention, K8's whole form, the one-process expert layer
    and the stages in sequence."""
    import tempfile

    import torch.multiprocessing as mp

    from ray_tpu_torch.parallel.pipeline import reference_pipeline

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    t_phase = time.perf_counter()
    # K1's results, before the spawn (the card to itself)
    k1 = {name: [x.cpu().numpy() for x in KT.schedule_classes(*(T(a) for a in prob))]
          for name, prob in _k7r_problems().items()}
    avail, total, alive, demands, first = stream_first_round()
    k1_digests, av = [], T(avail)
    for rnd in range(K7R_ROUNDS):
        a, av = KT.schedule_classes(av, T(total), T(alive), T(demands),
                                    T(_stream_round_counts(first, rnd)))
        k1_digests.append(_digest(a, av))
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_phase11_rank, args=(PHASE11_RANKS, tmp, dev.type, ring_shape),
                                 nprocs=PHASE11_RANKS, join=False, start_method="spawn")
        try:
            # kernel_np on the host while the ranks run
            np_ref = {name: kernel_np.schedule_classes(*(np.array(a) for a in prob))
                      for name, prob in _k7r_problems().items()}
            np_digests, av_np = [], avail.copy()
            for rnd in range(K7R_ROUNDS):
                a, av_np = kernel_np.schedule_classes(av_np, total, alive, demands,
                                                      _stream_round_counts(first, rnd))
                np_digests.append(_digest(a, av_np))
            deadline = time.monotonic() + PHASE11_DEADLINE_S
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase 11: ranks still running after "
                                         f"{PHASE11_DEADLINE_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        spawn_s = time.perf_counter() - t_phase
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(PHASE11_RANKS)]
        info = []
        for r in range(PHASE11_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                info.append(json.load(f))
    res = {}
    # K7r: every rank's whole results against K1's and kernel_np's
    cells = 0
    for p in (2, 4):
        for r in range(p):
            for name in _k7r_problems():
                a, v = ranks[r][f"k7r_{p}_{name}_a"], ranks[r][f"k7r_{p}_{name}_v"]
                for want_a, want_v, ref in ((*k1[name], "K1"), (*np_ref[name], "kernel_np")):
                    n = int((a != want_a).sum() + (v != want_v).sum())
                    cells += n
                    if n:
                        raise AssertionError(f"K7r p={p} rank {r} {name}: {n} cells != {ref}")
            for rnd in range(K7R_ROUNDS):
                got = info[r]["digests"][f"{p}/stream{rnd}"]
                if got != k1_digests[rnd] or got != np_digests[rnd]:
                    raise AssertionError(f"K7r p={p} rank {r}: stream round {rnd} != K1 / "
                                         "kernel_np")
    res["k7r"] = {"differing_cells": cells, "problems": list(_k7r_problems()),
                  "stream_rounds": K7R_ROUNDS, "ranks": [2, 4]}
    log(f"  K7r p = 2, 4: {list(_k7r_problems())} and the stream's first round carried "
        f"{K7R_ROUNDS} rounds, on every rank, == K1 == kernel_np (0 differing cells)")
    # ring attention: bit-equal to ring_schedule in one process, and within
    # 6d's bound of whole attention; Ulysses against K8's whole form
    q, k, v = _ring_inputs(torch, dev, ring_shape)
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qd, kd, vd = (x.to(dt) for x in (q, k, v))
        ring = np.concatenate([ranks[r][f"ring_{name}"] for r in range(PHASE11_RANKS)], axis=1)
        sched = ring_schedule(torch, MK, qd, kd, vd, PHASE11_RANKS).float().cpu().numpy()
        if not np.array_equal(ring, sched):
            raise AssertionError(f"ring {name}: != ring_schedule in one process (max abs err "
                                 f"{float(np.abs(ring - sched).max())})")
        whole = MK.attention(qd, kd, vd, causal=True).double().cpu().numpy()
        rtol, atol = KERNEL_TOL[name]
        err = float(np.abs(ring - whole).max())
        if (np.abs(ring - whole) > atol + rtol * np.abs(whole)).any():
            raise AssertionError(f"ring {name}: vs whole attention max abs err {err}")
        res[f"ring_{name}"] = {"bit_equal_ring_schedule": True, "vs_whole_err": err}
        if name == "bf16":
            uly = np.concatenate([ranks[r]["ulysses_bf16"] for r in range(PHASE11_RANKS)],
                                 axis=1)
            d = np.abs(uly - whole)
            if (d > atol + rtol * np.abs(whole)).any():
                raise AssertionError(f"ulysses: vs K8's whole form max abs err {d.max()}")
            res["ulysses_bf16"] = {"bit_equal_whole": bool(np.array_equal(uly, whole)),
                                   "vs_whole_err": float(d.max())}
    # the expert layer against the one-process layer
    cfg, tree, _, x32 = _moe_layer(torch, PM, dev)
    x = x32.to(torch.bfloat16)
    y1, aux1 = PM.moe_ffn(PM.moe_params_from_numpy(tree, cfg, device=dev), x)
    route = EK.moe_route(torch.matmul(x.float(), T(tree["router"])),
                         PM._capacity(cfg, MOE_SHAPE[1]))
    y1, expert1, slot1 = y1.float().cpu().numpy(), route[0].cpu().numpy(), route[2].cpu().numpy()
    atol_y, atol_aux = PM.MOE_GOLDEN_TOL["bf16"]
    for tag, ep in (("1x4", 4), ("2x2", 2)):
        Gl = MOE_SHAPE[0] // (PHASE11_RANKS // ep)
        err_y = err_aux = 0.0
        for r in range(PHASE11_RANKS):
            blk = slice((r // ep) * Gl, (r // ep + 1) * Gl)
            if not (np.array_equal(ranks[r][f"moe_expert_{tag}"], expert1[blk])
                    and np.array_equal(ranks[r][f"moe_slot_{tag}"], slot1[blk])):
                raise AssertionError(f"moe {tag} rank {r}: routing != one process")
            err_y = max(err_y, float(np.abs(ranks[r][f"moe_y_{tag}"] - y1[blk]).max()))
            err_aux = max(err_aux, abs(float(ranks[r][f"moe_aux_{tag}"]) - float(aux1)))
        if not (err_y <= atol_y and err_aux <= atol_aux):
            raise AssertionError(f"moe {tag}: y err {err_y} (atol {atol_y}), aux err "
                                 f"{err_aux} (atol {atol_aux})")
        res[f"moe_{tag}"] = {"routing_equal": True, "y_err": err_y, "aux_err": err_aux}
    # the pipeline against the stages in sequence
    w, xs = _pipe_inputs(torch, dev)
    seq = reference_pipeline(_pipe_stage, w, xs).cpu().numpy()
    rtol, atol = KERNEL_TOL["f32"]
    err = 0.0
    for r in range(PHASE11_RANKS):
        d = np.abs(ranks[r]["pipe"] - seq)
        err = max(err, float(d.max()))
        if (d > atol + rtol * np.abs(seq)).any():
            raise AssertionError(f"pipeline rank {r}: max abs err {float(d.max())}")
    res["pipeline"] = {"vs_sequence_err": err,
                       "bit_equal": all(np.array_equal(ranks[r]["pipe"], seq)
                                        for r in range(PHASE11_RANKS))}
    # launches in the ranks' windows, summed over the ranks
    launches = {}
    for i in info:
        for name, n in i["launches"].items():
            launches[name] = launches.get(name, 0) + n
    ring_launches = sum(i["ring"]["launches"] for i in info)
    ring_tc = sum(i["ring"]["launches_tc"] for i in info)
    if dev.type == "cuda" and (launches["rank_pass"] == 0 or launches["block_update"] == 0):
        raise AssertionError(f"phase 11: K7r or K8's block form never launched: {launches}")
    if dev.type == "cuda" and (ring_launches != 2 * PHASE11_RANKS * PHASE11_RANKS
                               or ring_tc != ring_launches // 2):
        raise AssertionError(f"phase 11 ring: {ring_launches} block_update launches, "
                             f"{ring_tc} on the tensor cores")
    res["launches"] = launches
    res[PHASE11_TIMES_KEY] = {
        "by_rank": [i["times"] for i in info],
        "window_s_by_rank": [i["window_s"] for i in info],
        "k7r_launches_by_rank": [i["k7r_launches"] for i in info]}
    res["spawn_and_run_s"] = spawn_s
    rec = _k7r_record(torch, KS, KT, dev)
    rec["launches"] = launches["rank_pass"]
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 11 across ranks: {json.dumps({k: v for k, v in res.items() if k != PHASE11_TIMES_KEY})}")
    log(f"phase 11 {PHASE11_TIMES_KEY}: {json.dumps(res[PHASE11_TIMES_KEY])}")
    return res, rec


PHASE12_DEADLINE_S = 120
# (tag, dp, tp, dtype name, steps): the dp x tp train step at full width
MESH_TRAIN_CASES = (("bf16_2x2", 2, 2, "bf16", 3), ("f32_2x2", 2, 2, "f32", 1),
                    ("bf16_1x4", 1, 4, "bf16", 1))
MESH_MOE_CASES = ((2, 2), (1, 4))  # dp x ep
MESH_MOE_STEPS = 3
PHASE12_KERNELS = TRAIN_KERNELS + tuple(MOE_REPLACES) + ("moe_route_bwd", "moe_dispatch_bwd",
                                                         "moe_combine_bwd")
_DTYPES = {"bf16": "bfloat16", "f32": "float32"}


class _CollectiveClock:
    """Wraps a Mesh's collectives so that each call's host time (the stream
    synchronised before and after it) adds up in `ms`; gloo stages CUDA
    tensors through the host, which synchronises them anyway."""

    def __init__(self, torch, mesh_cls, dev):
        self.ms = 0.0
        sync_ = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (lambda: None)
        for name in ("psum", "all_gather", "all_to_all"):
            fn = getattr(mesh_cls, name)

            def timed(*args, _fn=fn, **kwargs):
                sync_()
                t = time.perf_counter()
                out = _fn(*args, **kwargs)
                sync_()
                self.ms += (time.perf_counter() - t) * 1e3
                return out

            setattr(mesh_cls, name, timed)


def _leaf_digests(PT, model) -> dict:
    tree = PT.to_numpy(model)
    leaves = {k: tree[k] for k in ("embed", "unembed", "ln_f")}
    leaves.update(tree["layers"])
    return {k: _digest(v) for k, v in leaves.items()}


def _phase12_kernels_at_shard_shapes(torch, MK, EK, PM, dev, x_block, router, C, n_tokens):
    """Rank 0's check, after its window: K8 and K8' at [4, 2048, 4, 64] and
    K10b and K10b' at [4, 2048, 768] with 4 heads (the 2 x 2 step's shards),
    bf16; K9a-c and K9a'-c' on the rank's "dp" block of the expert layer;
    each against its plain version (K8 with KERNEL_TOL, K8' and K10b' as
    phase 9a holds them, the routing and the gathers exactly, the rest
    within BWD_TOL of the largest entry)."""
    g = torch.Generator().manual_seed(12)
    bf = torch.bfloat16
    rnd = lambda shape, scale=1.0: (torch.randn(shape, generator=g) * scale).to(dev, bf)  # noqa
    err = {}

    def close(name, got, want, rtol, atol):
        gd, wd = got.double(), want.double()
        atol = max(atol, rtol * float(wd.abs().max()))
        d = float((gd - wd).abs().max())
        err[name] = max(err.get(name, 0.0), d)
        if bool(((gd - wd).abs() > atol + rtol * wd.abs()).any()) \
                or not bool(torch.isfinite(gd).all()):
            raise AssertionError(f"phase 12c {name}: kernel != plain (max abs err {d})")

    rtol, atol = KERNEL_TOL["bf16"]
    q, k, v = (rnd((4, 2048, 4, 64)) for _ in range(3))
    out, m, l = MK._attention_launch(q, k, v, True, True, stats=True)
    close("attention", out, MK._attention_rounded_plain(q, k, v, True)[0], rtol, atol)
    dout = rnd((4, 2048, 4, 64))
    for got, w in zip(MK.attention_bwd(q, k, v, dout, m, l, True),
                      MK._attention_bwd_plain(q, k, v, dout, m, l, True)):
        close("attention_bwd", got, w, rtol, atol)
    qkv = rnd((4, 2048, 768))
    for got, w in zip(MK.rope_split(qkv, 4, 10000.0), MK._rope_split_plain(qkv, 4, 10000.0)):
        close("rope_split", got, w, rtol, atol)
    dq, dk, dv = (rnd((4, 2048, 4, 64)) for _ in range(3))
    close("rope_split_bwd", MK.rope_split_bwd(dq, dk, dv, 10000.0),
          MK._rope_split_bwd_plain(dq, dk, dv, 10000.0), rtol, atol)
    logits = torch.matmul(x_block.float(), router)
    got = EK.moe_route(logits, C)
    err["moe_route"] = _route_err(torch, got, EK._route_plain(logits, C), "phase 12c")
    _, gate, slot, tos, stats = got
    cfg = PM.MoEConfig()
    if not torch.equal(EK.moe_dispatch(x_block, tos, cfg.dtype),
                       EK._dispatch_plain(x_block, tos, cfg.dtype)):
        raise AssertionError("phase 12c moe_dispatch: kernel != plain")
    G, S, D = x_block.shape
    rows = torch.randn((cfg.n_experts, G, C, D), generator=g).to(dev)
    if not torch.equal(EK.moe_combine(rows, slot, gate, bf), EK._combine_plain(rows, slot, gate, bf)):
        raise AssertionError("phase 12c moe_combine: kernel != plain")
    frac = EK.aux_loss(stats, n_tokens)[0]
    d_gate = torch.randn((G, S), generator=g).to(dev)
    d_aux = torch.full((1,), 0.01, device=dev)
    want = EK._route_bwd_plain(logits, d_gate, frac, d_aux, n_tokens)
    close("moe_route_bwd", EK.moe_route_bwd(logits, d_gate, frac, d_aux, n_tokens), want, 0.0,
          EK.BWD_TOL * float(want.abs().max()))
    d_in = rnd((cfg.n_experts, G, C, D))
    if not torch.equal(EK.moe_dispatch_bwd(d_in, slot, bf), EK._dispatch_bwd_plain(d_in, slot, bf)):
        raise AssertionError("phase 12c moe_dispatch_bwd: kernel != plain")
    dy = rnd((G, S, D))
    got, want = (f(dy, rows, slot, gate, tos) for f in (EK.moe_combine_bwd, EK._combine_bwd_plain))
    if not torch.equal(got[0], want[0]):
        raise AssertionError("phase 12c moe_combine_bwd: d_out != plain")
    close("moe_combine_bwd", got[1], want[1], 0.0, EK.BWD_TOL * float(want[1].abs().max()))
    for name in ("moe_dispatch", "moe_combine", "moe_dispatch_bwd"):
        err[name] = 0.0
    return err


def _phase12_rank(rank, world, tmp, device_type, cfg_kw, batch, seq):
    """One of phase 12's ranks on the one card (or the CPU, to rehearse):
    the dp x tp train step (MESH_TRAIN_CASES) and the expert layer's train
    step over dp x ep (MESH_MOE_CASES), its launch counters from 0 over
    them, each step timed by the host clock with its collectives apart;
    then, on rank 0, the kernels at their shard shapes (12c)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from ray_tpu_torch.models import kernels as MK, moe as PM, moe_kernels as EK
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import make_mesh, mesh as PMESH, tpu_train as TT

    if device_type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world, timeout=timedelta(seconds=PHASE12_DEADLINE_S))
    try:
        sync_ = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (lambda: None)
        meshes = {(dp, tp): make_mesh(("dp", "tp"), shape=(dp, tp), device=dev)
                  for _, dp, tp, _, _ in MESH_TRAIN_CASES}
        meshes_ep = {(dp, ep): make_mesh(("dp", "ep"), shape=(dp, ep), device=dev)
                     for dp, ep in MESH_MOE_CASES}
        cfg16 = PT.TransformerConfig(**cfg_kw)
        tree = PT.numpy_params(cfg16, TRAIN_SEED)
        tokens = _train_tokens(cfg16, batch, seq)
        cfg_m, tree_m, _, x32 = _moe_layer(torch, PM, dev)
        clock = _CollectiveClock(torch, PMESH.Mesh, dev)
        out, info = {}, {"losses": {}, "step_ms": {}, "collective_ms": {}, "digests": {}}
        dist.barrier()
        MK.reset_launch_counts()
        EK.reset_launch_counts()
        t_window = time.perf_counter()
        for tag, dp, tp, dt, steps in MESH_TRAIN_CASES:
            cfg = dataclasses.replace(cfg16, dtype=getattr(torch, _DTYPES[dt]))
            mesh = meshes[(dp, tp)]
            model = PT.shard_params(tree, cfg, mesh).requires_grad_(True)
            tx = TT.make_optimizer()
            state = tx.init(model)
            step, _ = TT.make_train_step(cfg, mesh, tx, PT.param_partition_specs(cfg))
            for key in ("losses", "step_ms", "collective_ms", "digests"):
                info[key][tag] = []
            for i in range(steps):
                sync_()
                clock.ms, t = 0.0, time.perf_counter()
                loss = float(step(model, state, {"tokens": tokens})[2])
                sync_()
                info["step_ms"][tag].append((time.perf_counter() - t) * 1e3)
                info["collective_ms"][tag].append(clock.ms)
                info["losses"][tag].append(loss)
                info["digests"][tag].append(_leaf_digests(PT, model))
                if i == 0:
                    whole = PT.gather_params(model, mesh)
                    if rank == 0:
                        np.savez(os.path.join(tmp, f"{tag}_params1.npz"), **{
                            **{k: whole[k] for k in ("embed", "unembed", "ln_f")},
                            **whole["layers"]})
                    del whole
            del model, state
        train_launches = {**MK.launch_counts()}
        C = PM._capacity(cfg_m, MOE_SHAPE[1])
        for dp, ep in MESH_MOE_CASES:
            tag = f"moe_{dp}x{ep}"
            mesh = meshes_ep[(dp, ep)]
            Gl = MOE_SHAPE[0] // dp
            d = mesh.axis_index("dp")
            local = PM.shard_moe_params(tree_m, cfg_m, mesh).requires_grad_(True)
            xb = x32[d * Gl:(d + 1) * Gl].to(torch.bfloat16).requires_grad_(True)
            tx = TT.make_optimizer(MOE_LR, MOE_WD)
            state = tx.init(local)
            for key in ("losses", "step_ms", "collective_ms", "digests"):
                info[key][tag] = []
            info.setdefault("moe_aux", {})[tag] = []
            for i in range(MESH_MOE_STEPS):
                sync_()
                clock.ms, t = 0.0, time.perf_counter()
                local.zero_grad(set_to_none=True)
                xb.grad = None
                y, aux = PM.moe_ffn(local, xb, cfg_m, mesh=mesh)
                task = (y.float() ** 2).mean()
                ((task + 0.01 * aux) * PM.mesh_loss_scale(mesh)).backward()
                PM.reduce_moe_grads(local, mesh, xb)
                if i == 0:
                    for key, g in PM.moe_grads_to_numpy(local).items():
                        out[f"{tag}_grad_{key}"] = g
                    out[f"{tag}_grad_x"] = xb.grad.float().cpu().numpy()
                tx.update(local, state)
                sync_()
                info["step_ms"][tag].append((time.perf_counter() - t) * 1e3)
                info["collective_ms"][tag].append(clock.ms)
                info["losses"][tag].append(float(task.detach()))  # this dp block's y ** 2 mean
                info["moe_aux"][tag].append(float(aux))
                for key, a in PM.moe_to_numpy(local).items():
                    out[f"{tag}_param{i}_{key}"] = a
        window_s = time.perf_counter() - t_window
        launches = {**MK.launch_counts(), **EK.launch_counts()}
        # after the window: the routing of step 1 (the initial router) on
        # each rank's block, and 12c on rank 0
        router0 = torch.from_numpy(tree_m["router"]).to(dev)
        for dp, ep in MESH_MOE_CASES:
            Gl = MOE_SHAPE[0] // dp
            d = meshes_ep[(dp, ep)].axis_index("dp")
            xb = x32[d * Gl:(d + 1) * Gl].to(torch.bfloat16)
            route = EK.moe_route(torch.matmul(xb.float(), router0), C)
            out[f"moe_{dp}x{ep}_expert"] = route[0].cpu().numpy()
            out[f"moe_{dp}x{ep}_slot"] = route[2].cpu().numpy()
        if rank == 0 and dev.type == "cuda":
            xb = x32[:MOE_SHAPE[0] // 2].to(torch.bfloat16).contiguous()
            info["kernels_at_shard_shapes"] = _phase12_kernels_at_shard_shapes(
                torch, MK, EK, PM, dev, xb, router0, C, MOE_SHAPE[0] * MOE_SHAPE[1])
        info.update(launches=launches, train_launches=train_launches, window_s=window_s)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        dist.destroy_process_group()


PARAM_SAMPLES, PARAM_POSITION_SEED = 4096, 7  # the training golden's sampling
_PARAM_LEAVES = ("embed", "unembed", "ln_f", "wqkv", "wo", "w1", "w2", "ln1", "ln2")


def _param_errors(got: dict, want_tree: dict) -> dict:
    """The gathered parameters against the one-process step's, as
    TRAIN_GOLDEN_TOL bounds them: param the max abs error over the
    golden's sampled positions (PARAM_SAMPLES a leaf, drawn as
    tests/test_torch_train.py draws them), param_share the least share of
    a leaf's entries within 1e-6 over every entry; and param_all, the max
    over every entry (an entry whose gradient is near AdamW's eps moves by
    up to lr on a last-bit difference of it), recorded, not bounded."""
    want = {k: want_tree[k] for k in ("embed", "unembed", "ln_f")}
    want.update(want_tree["layers"])
    rng = np.random.default_rng(PARAM_POSITION_SEED)
    err = {"param": 0.0, "param_all": 0.0, "param_share": 1.0}
    for k in _PARAM_LEAVES:
        d = np.abs(np.asarray(got[k]) - want[k]).reshape(-1)
        pos = rng.choice(d.size, min(PARAM_SAMPLES, d.size), replace=False)
        err["param"] = max(err["param"], float(d[pos].max()))
        err["param_all"] = max(err["param_all"], float(d.max()))
        err["param_share"] = min(err["param_share"], float((d <= 1e-6).mean()))
    return err


MOE_GRAD_POSITION_SEED = 11  # the expert layer's training golden's sampling


def _moe_grad_errors(full: dict, want: dict) -> tuple:
    """Step 1's gradients against the one-process step's as
    MOE_GRAD_GOLDEN_TOL bounds them: the max abs error over the golden's
    sampled positions (PARAM_SAMPLES a leaf in MOE_GRAD_LEAVES' order,
    drawn as tests/test_torch_moe_grads.py draws them) as a share of the
    leaf's rms; and the same over every entry (a bf16 gradient summed in
    another order can round one ulp away on its largest entries),
    recorded, not bounded."""
    from ray_tpu_torch.models.moe import MOE_GRAD_LEAVES

    rng = np.random.default_rng(MOE_GRAD_POSITION_SEED)
    err = err_all = 0.0
    for key in MOE_GRAD_LEAVES:
        w = want[key].astype(np.float64)
        rms = float(np.sqrt(np.mean(w ** 2)))
        d = np.abs(full[key] - w).reshape(-1) / rms
        pos = rng.choice(d.size, min(PARAM_SAMPLES, d.size), replace=False)
        err, err_all = max(err, float(d[pos].max())), max(err_all, float(d.max()))
    return err, err_all


def _phase12_references(torch, PT, TT, PM, dev, cfg_kw, batch, seq):
    """The one-process steps phase 12 is held to, on the card to itself
    before the spawn: the train step from numpy_params(cfg, 0) on phase 9b's
    tokens, bf16 (3 steps) and float32 (1), the losses and the parameters
    after step 1; the expert layer's step of phase 10 from phase 10b's
    weights and tokens (3 steps), the losses, aux, the gradients of step 1,
    the parameters after each step and step 1's routing."""
    ref = {}
    cfg16 = PT.TransformerConfig(**cfg_kw)
    tree = PT.numpy_params(cfg16, TRAIN_SEED)
    tokens = _train_tokens(cfg16, batch, seq)
    for dt, steps in (("bf16", 3), ("f32", 1)):
        cfg = dataclasses.replace(cfg16, dtype=getattr(torch, _DTYPES[dt]))
        model = PT.params_from_numpy(tree, cfg, device=dev).requires_grad_(True)
        tx = TT.make_optimizer()
        state = tx.init(model)
        step, _ = TT.make_train_step(cfg, None, tx)
        losses = []
        for i in range(steps):
            losses.append(float(step(model, state, {"tokens": tokens})[2]))
            if i == 0:
                ref[f"{dt}_params1"] = PT.to_numpy(model)
        ref[f"{dt}_losses"] = losses
        del model, state
    from ray_tpu_torch.models import moe_kernels as EK

    cfg_m, tree_m, x32, model, x, tx, state = _moe_train_setup(torch, PM, TT, dev)
    C = PM._capacity(cfg_m, MOE_SHAPE[1])
    route = EK.moe_route(torch.matmul(x.detach().float(), model.router.detach()), C)
    ref["moe_expert"], ref["moe_slot"] = route[0].cpu().numpy(), route[2].cpu().numpy()
    ref["moe_losses"], ref["moe_aux"], ref["moe_params"] = [], [], []
    for i in range(MESH_MOE_STEPS):
        model.zero_grad(set_to_none=True)
        x.grad = None
        y, aux = PM.moe_ffn(model, x)
        loss = _moe_loss(y, aux)
        loss.backward()
        if i == 0:
            ref["moe_grads"] = dict(PM.moe_grads_to_numpy(model),
                                    x=x.grad.float().cpu().numpy())
        tx.update(model, state)
        ref["moe_losses"].append(float(loss.detach()))
        ref["moe_aux"].append(float(aux.detach()))
        ref["moe_params"].append(PM.moe_to_numpy(model))
    return ref


def phase12_train_ranks(torch, PT, TT, PM, dev, cfg_kw=None, batch=8, seq=2048):
    """Training across ranks: 4 processes on the one card in one gloo group
    over CUDA tensors, spawned once (the kernels built by this process
    before). (a) the dp x tp train step at TransformerConfig() (bf16, or
    `cfg_kw` to rehearse) from numpy_params(cfg, 0) on phase 9b's tokens
    [8, 2049]: 3 steps at dp x tp = 2 x 2, one float32 step there, one
    step at 1 x 4; each step's loss and the gathered parameters after step 1
    against the one-process step within TRAIN_GOLDEN_TOL; the leaves
    replicated over an axis bit-equal on every rank that holds them after
    every step. (b) the expert layer's train step (phase 10's: MoEConfig(),
    x [8, 2048, 256] bf16, AdamW) over dp x ep = 2 x 2 and 1 x 4, 3 steps
    each, against phase 10's one-process step within
    MOE_GRAD_GOLDEN_TOL["bf16"], the routing exact. (c) rank 0's kernels at
    their shard shapes against their plain versions. Every kernel of the
    two steps must have launched on every rank. Each rank's ms a step by
    the host clock, and its collectives' ms, are of 4 processes sharing one
    card over gloo."""
    import tempfile

    import torch.multiprocessing as mp

    cfg_kw = dict(cfg_kw or {})
    t_phase = time.perf_counter()
    deadline = time.monotonic() + PHASE12_DEADLINE_S
    ref = _phase12_references(torch, PT, TT, PM, dev, cfg_kw, batch, seq)
    ref_s = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory() as tmp:
        t_spawn = time.perf_counter()
        ctx = mp.start_processes(_phase12_rank, args=(PHASE11_RANKS, tmp, dev.type, cfg_kw,
                                                      batch, seq),
                                 nprocs=PHASE11_RANKS, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase 12: ranks still running "
                                         f"{PHASE12_DEADLINE_S} s after the phase began")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        spawn_s = time.perf_counter() - t_spawn
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(PHASE11_RANKS)]
        info = []
        for r in range(PHASE11_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                info.append(json.load(f))
        params1 = {tag: dict(np.load(os.path.join(tmp, f"{tag}_params1.npz")))
                   for tag, *_ in MESH_TRAIN_CASES}
    res = {"reference_s": ref_s, "spawn_and_run_s": spawn_s}
    # (a) the dp x tp step
    for tag, dp, tp, dt, steps in MESH_TRAIN_CASES:
        tol = TT.TRAIN_GOLDEN_TOL[dt]
        want = ref[f"{dt}_losses"]
        losses = [i["losses"][tag] for i in info]
        if any(lo != losses[0] for lo in losses):
            raise AssertionError(f"phase 12a {tag}: the ranks' losses differ: {losses}")
        loss_err = [abs(a - b) for a, b in zip(losses[0], want)]
        for i, e in enumerate(loss_err):
            if not e <= tol["loss" if i == 0 else "loss2"]:
                raise AssertionError(f"phase 12a {tag} step {i + 1}: loss {losses[0][i]} vs "
                                     f"one process {want[i]} (err {e})")
        perr = _param_errors(params1[tag], ref[f"{dt}_params1"])
        if not (perr["param"] <= tol["param"] and perr["param_share"] >= tol["param_share"]):
            raise AssertionError(f"phase 12a {tag}: gathered params after step 1 {perr} (tol "
                                 f"{tol['param']}, {tol['param_share']})")
        layout = np.arange(PHASE11_RANKS).reshape(dp, tp)
        for i in range(steps):
            for leaf, d0 in info[0]["digests"][tag][i].items():
                split = leaf in ("embed", "unembed", "wqkv", "wo", "w1", "w2")
                for r in range(PHASE11_RANKS):
                    holder = int(layout[0, r % tp]) if split else 0
                    if info[r]["digests"][tag][i][leaf] != info[holder]["digests"][tag][i][leaf]:
                        raise AssertionError(f"phase 12a {tag} step {i + 1}: {leaf} on rank "
                                             f"{r} != rank {holder}")
        res[tag] = {"losses": losses[0], "loss_err": loss_err, **perr,
                    "replicated_leaves_bit_equal": True}
    # (b) the expert layer's step
    tol = PM.MOE_GRAD_GOLDEN_TOL["bf16"]
    for dp, ep in MESH_MOE_CASES:
        tag = f"moe_{dp}x{ep}"
        n, Gl = PM.MoEConfig().n_experts // ep, MOE_SHAPE[0] // dp
        layout = np.arange(PHASE11_RANKS).reshape(dp, ep)
        losses = [float(np.mean([info[int(layout[d, 0])]["losses"][tag][i] for d in range(dp)])
                        + 0.01 * info[0]["moe_aux"][tag][i]) for i in range(MESH_MOE_STEPS)]
        loss_err = max(abs(a - b) for a, b in zip(losses, ref["moe_losses"]))
        aux_err = max(abs(info[r]["moe_aux"][tag][i] - ref["moe_aux"][i])
                      for r in range(PHASE11_RANKS) for i in range(MESH_MOE_STEPS))
        if not (loss_err <= tol["loss"] and aux_err <= tol["aux"]):
            raise AssertionError(f"phase 12b {tag}: loss err {loss_err}, aux err {aux_err}")
        # step 1's gradients, whole: each block from a rank that holds it
        full = {"router": ranks[0][f"{tag}_grad_router"],
                "x": np.concatenate([ranks[int(layout[d, 0])][f"{tag}_grad_x"]
                                     for d in range(dp)])}
        for key in ("w1", "w2"):
            full[key] = np.concatenate([ranks[int(layout[0, e])][f"{tag}_grad_{key}"]
                                        for e in range(ep)])
        param_err = 0.0
        share = 1.0
        for r in range(PHASE11_RANKS):
            d, e = divmod(r, ep)
            blk = {"router": slice(None), "w1": slice(e * n, (e + 1) * n),
                   "w2": slice(e * n, (e + 1) * n), "x": slice(d * Gl, (d + 1) * Gl)}
            if not (np.array_equal(ranks[r][f"{tag}_expert"], ref["moe_expert"][blk["x"]])
                    and np.array_equal(ranks[r][f"{tag}_slot"], ref["moe_slot"][blk["x"]])):
                raise AssertionError(f"phase 12b {tag} rank {r}: routing != one process")
            for key, b in blk.items():
                if not np.array_equal(ranks[r][f"{tag}_grad_{key}"], full[key][b]):
                    raise AssertionError(f"phase 12b {tag}: rank {r}'s gradient of {key} != "
                                         "the other ranks' that hold it")
            for i in range(MESH_MOE_STEPS):
                for key in ("router", "w1", "w2"):
                    got = ranks[r][f"{tag}_param{i}_{key}"]
                    diff = np.abs(got - ref["moe_params"][i][key][blk[key]])
                    param_err = max(param_err, float(diff.max()))
                    share = min(share, float((diff <= 1e-6).mean()))
                    holder = 0 if key == "router" else int(layout[0, e])
                    if not np.array_equal(got, ranks[holder][f"{tag}_param{i}_{key}"]):
                        raise AssertionError(f"phase 12b {tag} step {i + 1}: {key} on rank {r} "
                                             f"!= rank {holder}")
        grad_err, grad_err_all = _moe_grad_errors(full, ref["moe_grads"])
        if not (grad_err <= tol["grad"] and param_err <= tol["param"]
                and share >= tol["param_share"]):
            raise AssertionError(f"phase 12b {tag}: gradients {grad_err} of the rms, params "
                                 f"max abs err {param_err}, share within 1e-6 {share}")
        res[tag] = {"losses": losses, "loss_err": loss_err, "aux_err": aux_err,
                    "grad_err_of_rms": grad_err, "grad_err_of_rms_all": grad_err_all,
                    "param_err": param_err, "param_share": share, "routing_equal": True,
                    "replicated_leaves_bit_equal": True}
    # (c) and the launches: every kernel of the two steps on every rank
    if dev.type == "cuda":
        res["kernels_at_shard_shapes_max_abs_err"] = info[0]["kernels_at_shard_shapes"]
        for r, i in enumerate(info):
            missing = [k for k in PHASE12_KERNELS if i["launches"][k] == 0]
            if missing:
                raise AssertionError(f"phase 12 rank {r}: never launched {missing}")
    launches = {}
    for i in info:
        for name, n in i["launches"].items():
            launches[name] = launches.get(name, 0) + n
    res["launches"] = launches
    res[PHASE11_TIMES_KEY] = {
        "step_ms_by_rank": [i["step_ms"] for i in info],
        "collective_ms_by_rank": [i["collective_ms"] for i in info],
        "window_s_by_rank": [i["window_s"] for i in info]}
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12 training across ranks: "
        f"{json.dumps({k: v for k, v in res.items() if k != PHASE11_TIMES_KEY})}")
    log(f"phase 12 {PHASE11_TIMES_KEY}: {json.dumps(res[PHASE11_TIMES_KEY])}")
    return res


# ------------------------------------------------------------ cluster mode

#: phase 13's kernels in the GCS's process (the scheduler's) and in the
#: model actor's worker process (the forward's)
PHASE13_HEAD_KERNELS = ("schedule_classes", "scatter_rows", "delta_clip", "compact_nonzero",
                        *FUSED_REFRESH)
PHASE13_NODE_CPUS = 4
PHASE13_TASKS = 2000
PHASE13_OBJECT_BYTES = 200 * 10**6


def _reap(procs, timeout=20.0):
    """Wait for worker processes the daemons were told to stop; kill any
    that outlives the deadline. Returns the pids that had to be killed."""
    killed = []
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            killed.append(p.pid)
            p.kill()
            p.wait(timeout=10)
    return killed


def _cluster_procs(c):
    return [w.proc for d in c.daemons for w in list(d.workers.values())
            if w.proc is not None]


def _shm_room(n_stores, store_bytes, phase="13"):
    """/dev/shm's free bytes, checked against the stores the phase creates:
    a segment larger than the mount's room is created (ftruncate reserves
    nothing) and faults at the first write past it, so the phase fails
    here instead, with the numbers."""
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    need = n_stores * store_bytes
    log(f"phase {phase} /dev/shm: {free / 2**20:.1f} MiB free, {n_stores} stores of "
        f"{store_bytes / 2**20:.1f} MiB need {need / 2**20:.1f} MiB")
    if free < need:
        raise AssertionError(
            f"/dev/shm has {free / 2**20:.1f} MiB free; the {n_stores} node stores "
            f"need {need / 2**20:.1f} MiB: the native object store cannot be created")
    return free


def phase13_cluster(KT, ctx, requests, answers, gpu="cuda"):
    """Cluster mode on the card: (a) a two-node Cluster (GCS in this
    process, the default policy torch_cuda on the card) driven through
    init(address=...); (b) 6c's ModelServer as an actor in a worker
    process, its answers bit-equal to 6c's; (c) init(cluster=True) and
    shutdown(). Returns (results, the head's launches, the worker's)."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.config import Config

    overrides = {"jax_policy_min_cells": 0}
    if gpu != "cuda":
        overrides["scheduler_device"] = gpu
    config = Config(overrides)
    res = {}
    _shm_room(2, config.object_store_memory_bytes)

    # (a) two nodes, the driver connected by address
    KT.reset_launch_counts()
    t0 = time.perf_counter()
    c = Cluster(config=config)
    try:
        policy = c.gcs.policy
        assert policy.name == "torch_cuda" and policy.device.type == gpu, \
            f"GCS policy {policy.name} on {policy.device}"
        for node in ("node-a", "node-b"):
            c.add_node(num_cpus=PHASE13_NODE_CPUS, node_id=node)
        c.wait_for_nodes(2, timeout=60)
        for d in c.daemons:
            if not d.shm_name or type(d.store).__name__ != "ShmNodeStore":
                raise AssertionError(f"daemon {d.node_id} is not on the native shm store "
                                     f"(store {type(d.store).__name__}, shm {d.shm_name})")
            # session files (spill, DAG channels) stay under TMPDIR's own root
            for path in (d.store.spill_dir, d.chan_dir):
                if not path.startswith(os.path.join(tempfile.gettempdir(), "ray_tpu_torch")):
                    raise AssertionError(f"daemon {d.node_id} writes under {path}")
        rt.init(address=c.address)
        res["boot_s"] = time.perf_counter() - t0

        @rt.remote
        def square(x):
            return x * x

        t0 = time.perf_counter()
        got = rt.get([square.remote(i) for i in range(PHASE13_TASKS)], timeout=300)
        t_tasks = time.perf_counter() - t0
        assert got == [i * i for i in range(PHASE13_TASKS)], "phase 13 task results differ"
        res["tasks"] = PHASE13_TASKS
        res["tasks_per_s"] = PHASE13_TASKS / t_tasks

        with tempfile.TemporaryDirectory() as barrier:
            @rt.remote(num_cpus=1)
            def where(barrier_dir):
                node = os.environ.get("RAY_TPU_NODE_ID")
                open(os.path.join(barrier_dir, node), "w").close()
                deadline = time.time() + 60
                while len(os.listdir(barrier_dir)) < 2:
                    if time.time() > deadline:
                        raise TimeoutError(f"only {os.listdir(barrier_dir)} at the barrier")
                    time.sleep(0.01)
                return node

            # more tasks than one node's CPUs: those waiting on one node
            # hold its CPUs, so the rest must be placed on the other
            nodes = set(rt.get([where.remote(barrier)
                                for _ in range(2 * PHASE13_NODE_CPUS)], timeout=120))
        assert nodes == {"node-a", "node-b"}, f"barrier reached by {nodes}"

        arr = np.random.default_rng(130).integers(
            0, 2**31, PHASE13_OBJECT_BYTES // 4, dtype=np.int32)
        t0 = time.perf_counter()
        ref = rt.put(arr)
        back = rt.get(ref, timeout=120)
        t_obj = time.perf_counter() - t0
        assert back.dtype == arr.dtype and back.shape == arr.shape \
            and np.array_equal(back, arr), "the 200 MB object came back different"
        res["object_mb"] = arr.nbytes / 1e6
        res["object_round_trip_mb_per_s"] = arr.nbytes / 1e6 / t_obj
        del ref, back, arr
        @rt.remote
        def attached():
            # the worker runs as `python -m ray_tpu_torch.cluster.worker`
            return sys.modules["__main__"]._shm is not None

        if not all(rt.get([attached.remote() for _ in range(16)], timeout=120)):
            raise AssertionError("a worker did not map its node's shm store")
        small = {"k": [1, 2, 3], "v": np.arange(10.0)}
        back = rt.get(rt.put(small), timeout=30)
        assert back["k"] == small["k"] and np.array_equal(back["v"], small["v"])

        # (b) 6c's ModelServer as an actor in a worker process
        t0 = time.perf_counter()
        w_ref = rt.put(ctx["tree"])
        t_put = time.perf_counter() - t0
        spilled = {d.node_id: len(getattr(d.store, "_spilled", {})) for d in c.daemons}
        log(f"phase 13b weights: put in {t_put:.3f} s, objects spilled by node "
            f"{spilled}, /dev/shm "
            f"{os.statvfs('/dev/shm').f_bavail * os.statvfs('/dev/shm').f_frsize / 2**20:.1f}"
            " MiB free")
        res["weights_spilled"] = spilled
        t0 = time.perf_counter()
        server = rt.remote(ModelServer).remote(w_ref, ctx["cfg"], ctx["model"].device)
        first = rt.get(server.last_logits.remote(requests[0]), timeout=600)
        res["first_answer_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = rt.get([server.last_logits.remote(t) for t in requests], timeout=600)
        res["serve_s"] = time.perf_counter() - t0
        worker_pid = rt.get(server.pid.remote(), timeout=60)
        assert worker_pid != os.getpid(), "the model actor runs in the driver's process"
        res["actor_pid_differs"] = True
        for i, (a, b) in enumerate(zip([first] + served, [answers[0]] + answers)):
            if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"phase 13b answer {i} differs from 6c's "
                                     f"(max |diff| {np.abs(a - b).max()})")
        worker_launches, worker_tc = rt.get(server.launches.remote(), timeout=60)
        head_launches = KT.launch_counts()
    finally:
        procs = _cluster_procs(c)
        try:
            rt.shutdown()
        finally:
            c.shutdown()
            killed = _reap(procs)
    assert procs and not killed, \
        f"worker processes still alive 20 s after shutdown (killed): {killed}"
    log(f"phase 13b model actor: worker launches {worker_launches}, "
        f"tensor-core {worker_tc}")
    if gpu == "cuda":
        for k in ("schedule_classes",):
            if head_launches[k] == 0:
                raise AssertionError(f"the GCS's rounds never launched {k}: {head_launches}")
        if head_launches["scatter_rows"] + head_launches["delta_clip"] == 0:
            raise AssertionError(f"the GCS's rounds never refreshed the view: {head_launches}")
        require_fused(refresh_forms({}, head_launches), "phase 13 (the GCS's scan rounds)")
        missing = [k for k in FORWARD_KERNELS if worker_launches[k] == 0]
        if missing:
            raise AssertionError(f"the model actor's worker never launched {missing}")
        if worker_tc["attention"] != worker_launches["attention"]:
            raise AssertionError(f"worker: {worker_launches['attention']} K8 launches, "
                                 f"{worker_tc['attention']} on the tensor cores")

    # (c) the embedded cluster of init(cluster=True)
    t0 = time.perf_counter()
    rt.init(cluster=True, num_nodes=2, _system_config=overrides)
    try:
        emb = rt.core.api._embedded_cluster
        assert len(emb.daemons) == 2 and all(d.shm_name for d in emb.daemons)
        assert emb.gcs.policy.device.type == gpu

        @rt.remote
        def echo(x):
            return x

        assert rt.get(echo.remote("round trip"), timeout=120) == "round trip"
        procs = _cluster_procs(emb)
    finally:
        rt.shutdown()
    assert rt.core.api._embedded_cluster is None
    killed = _reap(procs)
    assert procs and not killed, \
        f"embedded cluster's workers still alive 20 s after shutdown (killed): {killed}"
    res["embedded_s"] = time.perf_counter() - t0
    log(f"phase 13: {json.dumps(res)}")
    return res, {k: head_launches[k] for k in PHASE13_HEAD_KERNELS}, \
        {k: worker_launches[k] for k in FORWARD_KERNELS}


#: phase 14's kernels in the GCS's process: K1 (every round) and K3 (a
#: delta uploaded while an earlier round is still in flight: only where the
#: post stage's eager tasks happen to overlap, so it is reported, not
#: required; K2 never runs at two nodes, where any dirty row is half the
#: view and the view is uploaded whole)
PHASE14_HEAD_KERNELS = ("schedule_classes", "delta_clip")
PHASE14_NODES = ("node-gpu", "node-post")


def phase14_post(logits):
    """The compiled graph's CPU stage: the logits passed on, each row's
    argmax and a float64 checksum."""
    return {"logits": logits, "argmax": logits.argmax(-1),
            "checksum": float(logits.astype(np.float64).sum())}


def _same_post(got, want):
    return (got["logits"].dtype == want["logits"].dtype
            and got["logits"].shape == want["logits"].shape
            and np.array_equal(got["logits"], want["logits"])
            and np.array_equal(got["argmax"], want["argmax"])
            and got["checksum"] == want["checksum"])


def _chan_files(c):
    return sorted(os.path.join(d.chan_dir, f) for d in c.daemons
                  for f in os.listdir(d.chan_dir))


def phase14_serve(KT, ctx, requests, answers, gpu="cuda"):
    """The serving path on the card, in a two-node Cluster of its own (the
    GCS's default policy on the card, jax_policy_min_cells 0): node-gpu
    offers {"GPU": 1}, node-post a CPU stage's resource. (a) serve's fast
    path: ModelServer deployed with fast_path=True and
    ray_actor_options={"num_gpus": 1}, the full-width weights through the
    object store; 6c's 8 requests through a DeploymentHandle, bit-equal to
    6c's answers; fastpath_stats() completed == submitted, no failure, no
    duplicate; one request through the HTTP proxy. (b) a compiled graph:
    InputNode -> ModelServer.last_logits (an actor asking for the GPU) ->
    phase14_post on node-post (the cross-node edge, over rpc_dag_push /
    rpc_dag_pull), and the same graph on node-gpu alone; 8 execute calls
    each equal to 6c's answers, and the eager dag.execute of both graphs
    too; teardown() leaves no channel file and no stage worker.
    Returns (results, the head's launches, the replica's, the stage's)."""
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.dag import InputNode

    t_phase = time.perf_counter()
    overrides = {"jax_policy_min_cells": 0}
    if gpu != "cuda":
        overrides["scheduler_device"] = gpu
    config = Config(overrides)
    _shm_room(2, config.object_store_memory_bytes)
    dev = ctx["model"].device
    want_post = [phase14_post(a) for a in answers]
    res = {}
    KT.reset_launch_counts()
    c = Cluster(config=config)
    try:
        c.add_node(num_cpus=PHASE13_NODE_CPUS, node_id=PHASE14_NODES[0],
                   resources={"GPU": 1, "LOCAL": 1})
        c.add_node(num_cpus=PHASE13_NODE_CPUS, node_id=PHASE14_NODES[1],
                   resources={"POST": 1})
        c.wait_for_nodes(2, timeout=60)
        rt.init(address=c.address)

        # (a) the fast path, a replica on the GPU node; its constructor gets
        # the weights from the object store
        t0 = time.perf_counter()
        dep = serve.deployment(fast_path=True, ray_actor_options={"num_gpus": 1},
                               name="ModelServer")(ModelServer)
        w_ref = rt.put(ctx["tree"])
        h = serve.run(dep.bind(w_ref, ctx["cfg"], dev), name="model",
                      route_prefix="/model", http_port=0)
        first = h.last_logits.remote(requests[0]).result(timeout=600)
        res["first_answer_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pending = [h.last_logits.remote(t) for t in requests]
        served = [r.result(timeout=600) for r in pending]
        res["fastpath_8_requests_s"] = time.perf_counter() - t0
        hosts = {d.node_id for d in c.daemons for w in list(d.workers.values())
                 if w.serve_pairs}
        if hosts != {PHASE14_NODES[0]}:
            raise AssertionError(f"the fast-path replica is hosted on {hosts}")
        for i, (a, b) in enumerate(zip([first] + served, [answers[0]] + answers)):
            if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"phase 14a answer {i} differs from 6c's "
                                     f"(max |diff| {np.abs(a - b).max()})")
        stats = h.fastpath_stats()
        res["fastpath_stats"] = stats
        if stats is None or stats["completed"] != stats["submitted"] \
                or stats["failed"] or stats["duplicates"]:
            raise AssertionError(f"phase 14a fast path stats {stats}")
        small = min(range(len(requests)), key=lambda i: requests[i].size)
        t0 = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{serve.http_port()}/model",
            data=json.dumps({"tokens": requests[small].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
        res["http_request_s"] = time.perf_counter() - t0
        via_http = np.asarray(body["logits"], dtype=np.float32)
        if not np.array_equal(via_http, answers[small]):
            raise AssertionError(f"phase 14a HTTP answer to request {small} differs from 6c's")
        replica_launches, replica_tc = h.launches.remote().result(timeout=60)
        serve.shutdown()

        # (b) a compiled graph: the model stage on node-gpu, the post stage
        # on node-post (the cross-node edge); then the same graph with the
        # post stage on node-gpu, whose iterations differ by that edge alone.
        # The stage binds (a)'s weights again: the controller forwarded the
        # ref into the replica's constructor, and this process still owns
        # and holds it
        t0 = time.perf_counter()
        if not c.gcs.directory.get(w_ref.id):
            raise AssertionError("phase 14b: the weights bound in 14a were freed while "
                                 "this process holds their ref")
        model = rt.remote(num_gpus=1)(ModelServer).remote(w_ref, ctx["cfg"], dev)
        rt.get(model.pid.remote(), timeout=600)  # the stage's actor is up
        res["stage_actor_s"] = time.perf_counter() - t0
        graph_ms, dags = {}, {}
        for where, resources in (("cross_node", {"POST": 1}), ("same_node", {"LOCAL": 1})):
            t0 = time.perf_counter()
            post = rt.remote(resources=resources)(phase14_post)
            with InputNode() as inp:
                dag = post.bind(model.last_logits.bind(inp))
            compiled = dag.compile()
            placed = {p["node_id"] for p in compiled._placements.values()}
            want_nodes = set(PHASE14_NODES) if where == "cross_node" else {PHASE14_NODES[0]}
            if placed != want_nodes:
                raise AssertionError(f"the {where} graph's stages are on {placed}")
            res[f"{where}_compile_s"] = time.perf_counter() - t0
            iter_ms, outs = [], []
            try:
                for t in requests:
                    t1 = time.perf_counter()
                    outs.append(compiled.execute(t, timeout=600))
                    iter_ms.append((time.perf_counter() - t1) * 1e3)
            finally:
                compiled.teardown()
            for i, (a, w) in enumerate(zip(outs, want_post)):
                if not _same_post(a, w):
                    raise AssertionError(f"phase 14b {where} iteration {i}: the compiled "
                                         "graph's output differs from 6c's answer")
            dags[where] = dag
            graph_ms[where] = iter_ms
            res[f"{where}_first_ms"] = iter_ms[0]
            res[f"{where}_ms_median"] = float(np.median(iter_ms))
        # both graphs eagerly, every request at once: the post stage's 16
        # tasks go through the GCS's rounds while earlier ones complete
        eager = rt.get([dag.execute(t) for dag in dags.values() for t in requests],
                       timeout=600)
        for i, (b, w) in enumerate(zip(eager, want_post * len(dags))):
            if not _same_post(b, w):
                raise AssertionError(f"phase 14b eager execute {i} differs from 6c's answer")
        res["cross_node_edge_ms_median"] = float(
            np.median(graph_ms["cross_node"]) - np.median(graph_ms["same_node"]))
        stage_launches, stage_tc = rt.get(model.launches.remote(), timeout=60)
        deadline = time.time() + 30
        while True:
            files = _chan_files(c)
            pinned = [w.worker_id for d in c.daemons for w in list(d.workers.values())
                      if w.dag_stages]
            holds = [k for k in c.gcs.running if k.startswith("dag-hold-")]
            if not (files or pinned or holds or c.gcs.dags
                    or any(d._dags for d in c.daemons)):
                break
            if time.time() > deadline:
                raise AssertionError(f"after teardown: channel files {files}, pinned "
                                     f"workers {pinned}, holds {holds}, dags "
                                     f"{list(c.gcs.dags)}")
            time.sleep(0.1)
        head_launches = KT.launch_counts()
    finally:
        procs = _cluster_procs(c)
        try:
            serve.shutdown()
            rt.shutdown()
        finally:
            c.shutdown()
            killed = _reap(procs)
    assert procs and not killed, \
        f"worker processes still alive 20 s after shutdown (killed): {killed}"
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 14 launches: head {head_launches}; replica {replica_launches}, "
        f"tensor-core {replica_tc}; stage {stage_launches}, tensor-core {stage_tc}")
    if gpu == "cuda":
        if head_launches["schedule_classes"] == 0:
            raise AssertionError(f"the GCS's rounds never launched K1: {head_launches}")
        for who, got, tc in (("replica", replica_launches, replica_tc),
                             ("stage", stage_launches, stage_tc)):
            missing = [k for k in FORWARD_KERNELS if got[k] == 0]
            if missing:
                raise AssertionError(f"the {who}'s worker never launched {missing}")
            if tc["attention"] != got["attention"]:
                raise AssertionError(f"{who}: {got['attention']} K8 launches, "
                                     f"{tc['attention']} on the tensor cores")
    log(f"phase 14: {json.dumps(res)}")
    return res, {k: head_launches[k] for k in PHASE14_HEAD_KERNELS}, \
        {k: replica_launches[k] for k in FORWARD_KERNELS}, \
        {k: stage_launches[k] for k in FORWARD_KERNELS}


# --------------------------------------------- phase 15: the Train library

PHASE15_NODE = "node-gpu"
PHASE15_STEPS = 6  # 15a: ACTOR_STEPS, the checkpoint, the failure, then the rest
PHASE15_PROFILED = 2  # 15b: the first attempt's first steps under profile_device
PHASE15_MESH_STEPS = 3  # 15c: two workers, dp 2 x tp 1
PHASE15_DEAD_AFTER_S = 20.0
# 15b: the trace must hold these kernels (CUDA symbols): K8 on the tensor
# cores, K8' (its two launches), K10a', K10b' in its rows form
PHASE15_TRACE_KERNELS = {"attention": ("attention_sm90_fwd_kernel",),
                         "attention_bwd": ("attention_sm90_bwd_dq_kernel",
                                           "attention_sm90_bwd_dkv_kernel"),
                         "rmsnorm_bwd": ("rmsnorm_bwd_kernel",),
                         "rope_split_bwd": ("rope_split_bwd_rows_kernel",)}


def _trace_kernel_counts(logdir, symbols):
    """Kernel records by symbol in the Chrome traces under logdir."""
    import re

    names = []
    for f in sorted(os.listdir(logdir)):
        with open(os.path.join(logdir, f)) as fh:
            names += [ev.get("name", "") for ev in json.load(fh).get("traceEvents", [])
                      if ev.get("cat") == "kernel"]
    return {sym: sum(1 for n in names if re.search(rf"\b{sym}\b", n)) for sym in symbols}


def _worker_counts():
    """A train worker's model-kernel counters (WorkerGroup.execute("run", ...))."""
    from ray_tpu_torch.models import kernels as MK

    return {"pid": os.getpid(), "launches": MK.launch_counts(), "tc": MK.tc_launch_counts(),
            "rows": MK.rope_split_bwd.launches_rows}


def phase15_loop(config):
    """15a-b's train loop (one worker): make_train_state on prepare_mesh's
    one-rank mesh (the card), or the checkpoint's state on a restart; a
    step and a report each; after ACTOR_STEPS steps a checkpoint of the
    parameters and AdamW's state (save_pytree), then, on the first attempt,
    an injected error. The first attempt runs its first PHASE15_PROFILED
    steps under profile_device. Writes its timings to
    <trial_dir>/attempt_<pid>.json."""
    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import tpu_train as TT
    from ray_tpu_torch.util.accelerators import current_accelerator_type
    from ray_tpu_torch.util.tracing import LostDeviceRecordsError, profile_device

    rec = {"pid": os.getpid(), "loop_start": time.time(), "step_s": {}}
    t0 = time.perf_counter()
    ctx = train.get_context()
    cfg = config["cfg"]
    mesh = train.prepare_mesh(("dp", "tp"), device=config["device"])
    ckpt = train.get_checkpoint()
    rec["resumed"] = ckpt is not None
    if ckpt is None:
        params, state, tx, shardings = TT.make_train_state(cfg, mesh, seed=config["seed"])
    else:
        t1 = time.perf_counter()
        tree = train.load_pytree(ckpt)
        params = PT.params_from_numpy(tree["params"], cfg, device=mesh.device)
        params.requires_grad_(True)
        state = TT.opt_state_from_numpy(tree["opt"], params)
        tx, shardings = TT.make_optimizer(), None
        rec["load_s"] = time.perf_counter() - t1
    step, _ = TT.make_train_step(cfg, mesh, tx, shardings)
    batch = {"tokens": train.prepare_data_shard(config["tokens"], mesh)}
    rec["setup_s"] = time.perf_counter() - t0
    rec["accelerator_type"] = current_accelerator_type() if mesh.device.type == "cuda" else None
    path = os.path.join(ctx.get_trial_dir(), f"attempt_{os.getpid()}.json")

    def take_step(i):
        t1 = time.perf_counter()
        _, _, loss = step(params, state, batch)
        metrics = {"loss": float(loss), "step": i + 1}
        rec["step_s"][i + 1] = time.perf_counter() - t1
        if i + 1 != config["checkpoint_after"]:
            train.report(metrics)
            return
        t1 = time.perf_counter()
        d = os.path.join(ctx.get_trial_dir(), f"wip_{os.getpid()}")
        out = train.save_pytree({"params": PT.to_numpy(params),
                                 "opt": TT.opt_state_to_numpy(state)}, d)
        rec["save_s"] = time.perf_counter() - t1
        rec["checkpoint_mb"] = sum(os.path.getsize(os.path.join(d, f))
                                   for f in os.listdir(d)) / 1e6
        metrics["checksum"] = PT.weights_checksum(PT.to_numpy(params))
        t1 = time.perf_counter()
        train.report(metrics, checkpoint=out)
        rec["report_s"] = time.perf_counter() - t1
        if not rec["resumed"]:
            rec["failed_at"] = time.time()
            with open(path, "w") as f:
                json.dump(rec, f)
            raise RuntimeError(f"injected failure after step {i + 1}")

    start = state.count
    if not rec["resumed"]:
        profile_dir = os.path.join(ctx.get_trial_dir(), f"profile_{os.getpid()}")
        try:
            with profile_device(profile_dir):
                for i in range(PHASE15_PROFILED):
                    take_step(i)
            rec["profile"] = _trace_kernel_counts(
                profile_dir, [s for v in PHASE15_TRACE_KERNELS.values() for s in v])
        except LostDeviceRecordsError as e:
            rec["profile_guard"] = str(e)
        start = PHASE15_PROFILED
    for i in range(start, config["steps"]):
        take_step(i)
    with open(path, "w") as f:
        json.dump(rec, f)


def phase15_mesh_loop(config):
    """15c's train loop (two workers): prepare_mesh(("dp", "tp"), (2, 1))
    over the gloo group JaxBackend formed, make_train_state on it, 9b's
    global batch through prepare_data_shard, a report a step; every rank
    writes its losses, its steps' seconds and a sha256 of every leaf to
    <trial_dir>/rank<r>.json."""
    import hashlib

    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import tpu_train as TT

    rec = {"pid": os.getpid(), "step_s": [], "losses": []}
    t0 = time.perf_counter()
    ctx = train.get_context()
    mesh = train.prepare_mesh(("dp", "tp"), (ctx.get_world_size(), 1), device=config["device"])
    params, state, tx, shardings = TT.make_train_state(config["cfg"], mesh, seed=config["seed"])
    step, _ = TT.make_train_step(config["cfg"], mesh, tx, shardings)
    batch = {"tokens": train.prepare_data_shard(config["tokens"], mesh)}
    rec["setup_s"] = time.perf_counter() - t0
    for i in range(config["steps"]):
        t1 = time.perf_counter()
        _, _, loss = step(params, state, batch)
        rec["losses"].append(float(loss))
        rec["step_s"].append(time.perf_counter() - t1)
        train.report({"loss": rec["losses"][-1], "step": i + 1})
    tree = PT.to_numpy(params)
    leaves = {k: tree[k] for k in ("embed", "unembed", "ln_f")}
    leaves.update({f"layers.{k}": v for k, v in tree["layers"].items()})
    rec["digests"] = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
                      for k, v in leaves.items()}
    with open(os.path.join(ctx.get_trial_dir(), f"rank{ctx.get_world_rank()}.json"), "w") as f:
        json.dump(rec, f)


def _pid_alive(pid):
    """Whether a process runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except (FileNotFoundError, ProcessLookupError):
        return False


def _records(path, prefix):
    """The JSON records a train loop wrote under path, by file name."""
    out = []
    for f in sorted(os.listdir(path)):
        if f.startswith(prefix) and f.endswith(".json"):
            with open(os.path.join(path, f)) as fh:
                out.append(json.load(fh))
    return out


def phase15_train(torch, PT, TT, ctx, gpu="cuda"):
    """The Train library on the card, in a Cluster of its own (the GCS's
    default policy on the card) with one node offering {"GPU": 1}. (a)
    JaxTrainer, one worker asking for the GPU, FailureConfig(max_failures
    =1), CheckpointConfig(num_to_keep=2): phase15_loop takes 9b's steps
    on 9b's tokens from 9b's seed, checkpoints after ACTOR_STEPS, fails,
    and the restarted group resumes from the checkpoint: every reported
    loss bit-equal to 9b's of the same step, the checkpoint's checksum and
    Result.checkpoint's (load_pytree -> params_from_numpy) equal to 9b's
    after ACTOR_STEPS; (b) its first steps under profile_device in the
    fresh worker: the trace holds K8 on the tensor cores, K8', K10a' and
    K10b' (rows), the guard silent, current_accelerator_type() "H100";
    (c) JaxTrainer, two workers sharing the card (GPU 0.5 each, one gloo
    group), dp 2 x tp 1 from 9b's seed on 9b's global batch: losses within
    TRAIN_GOLDEN_TOL["bf16"]["loss"] of 9b's, every leaf bit-equal across
    the ranks. Each worker's counters are read through WorkerGroup.execute
    when its group shuts down. No worker process is alive
    PHASE15_DEAD_AFTER_S after shutdown(). Returns (results, the launches
    summed over 15a's two workers, over 15c's two)."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.air import (CheckpointConfig, FailureConfig, RunConfig,
                                   ScalingConfig)
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.config import Config

    class CountingBackend(train.JaxBackend):
        """JaxBackend that reads every worker's counters through
        WorkerGroup.execute, and the node store's stats, before its group
        shuts down (a killed worker's objects, the spilled checkpoint's
        tar among them, are freed with it)."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.groups, self.stores = [], []

        def on_shutdown(self, worker_group):
            self.groups.append(worker_group.execute("run", _worker_counts))
            store = c.daemons[0].store.stats()
            self.stores.append({k: store.get(k) for k in ("objects", "spilled", "capacity")})
            super().on_shutdown(worker_group)

    t_phase = time.perf_counter()
    overrides = {"jax_policy_min_cells": 0}
    if gpu != "cuda":
        overrides["scheduler_device"] = gpu
    config = Config(overrides)
    _shm_room(1, config.object_store_memory_bytes, phase="15")
    cfg, tokens, dev = ctx["cfg"], ctx["tokens"], ctx["dev"]
    want_losses = ctx["losses"]
    storage = tempfile.mkdtemp(prefix="phase15_")
    res = {"store_mb": config.object_store_memory_bytes / 1e6}
    pids = []
    c = Cluster(config=config)
    try:
        c.add_node(num_cpus=PHASE13_NODE_CPUS, node_id=PHASE15_NODE, resources={"GPU": 1})
        c.wait_for_nodes(1, timeout=60)
        rt.init(address=c.address)

        # (a)-(b) one worker, a failure and a resume
        loop_config = {"cfg": cfg, "tokens": tokens, "seed": TRAIN_SEED,
                       "steps": PHASE15_STEPS, "checkpoint_after": ACTOR_STEPS,
                       "device": None if gpu == "cuda" else gpu}
        backend = CountingBackend()
        t0 = time.perf_counter()
        result = train.JaxTrainer(
            phase15_loop, train_loop_config=loop_config, jax_backend=backend,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=gpu == "cuda"),
            run_config=RunConfig(name="phase15a", storage_path=storage,
                                 failure_config=FailureConfig(max_failures=1),
                                 checkpoint_config=CheckpointConfig(num_to_keep=2))).fit()
        res["15a_fit_s"] = time.perf_counter() - t0
        if result.error is not None:
            raise AssertionError(f"phase 15a: the run failed: {result.error!r}")
        res["store_by_attempt"] = backend.stores
        if gpu == "cuda" and not backend.stores[0]["spilled"]:
            raise AssertionError(f"phase 15a: the checkpoint's tar did not spill from the "
                                 f"node's store: {backend.stores}")
        attempts = sorted(_records(result.path, "attempt_"), key=lambda r: r["loop_start"])
        pids += [r["pid"] for r in attempts]
        if [r["resumed"] for r in attempts] != [False, True]:
            raise AssertionError(f"phase 15a: attempts {[r['resumed'] for r in attempts]}, "
                                 "a first one and a resumed one expected")
        first, second = attempts
        got = [m["loss"] for m in result.metrics_history]
        steps = [m["step"] for m in result.metrics_history]
        if steps != list(range(1, PHASE15_STEPS + 1)) or got != want_losses[:PHASE15_STEPS]:
            raise AssertionError(f"phase 15a: steps {steps} losses {got}, 9b's "
                                 f"{want_losses[:PHASE15_STEPS]}")
        ck = [m for m in result.metrics_history if "checksum" in m]
        if len(ck) != 1 or ck[0]["checksum"] != ctx["checksum"]:
            raise AssertionError(f"phase 15a: the checkpoint's checksum {ck} != 9b's "
                                 f"{ctx['checksum'][:16]} after {ACTOR_STEPS} steps")
        tree = train.load_pytree(result.checkpoint)
        loaded = PT.weights_checksum(PT.to_numpy(PT.params_from_numpy(tree["params"], cfg,
                                                                      device=dev)))
        if loaded != ctx["checksum"] or int(tree["opt"]["count"]) != ACTOR_STEPS:
            raise AssertionError(f"phase 15a: Result.checkpoint's checksum {loaded[:16]} "
                                 f"(count {tree['opt']['count']}) != 9b's")
        res["15a"] = {
            "losses_equal_9b": True, "checksum_equal_9b": True,
            "first_step_s": [first["step_s"]["1"], second["step_s"][str(ACTOR_STEPS + 1)]],
            "setup_s": [first["setup_s"], second["setup_s"]],
            "step_ms_host": [1e3 * first["step_s"][str(i)]
                             for i in range(PHASE15_PROFILED + 1, ACTOR_STEPS + 1)]
            + [1e3 * second["step_s"][str(i)]
               for i in range(ACTOR_STEPS + 2, PHASE15_STEPS + 1)],
            "checkpoint_mb": first["checkpoint_mb"], "save_s": first["save_s"],
            "report_s": first["report_s"], "load_s": second["load_s"],
            "restart_s": second["loop_start"] - first["failed_at"],
            "fit_s": res["15a_fit_s"]}
        # (b) the profiled window of the first attempt
        if "profile_guard" in first:
            raise AssertionError(f"phase 15b: profile_device's guard fired: "
                                 f"{first['profile_guard']}")
        prof = first["profile"]
        missing = [k for k, syms in PHASE15_TRACE_KERNELS.items()
                   if not any(prof.get(s) for s in syms)]
        if missing and gpu == "cuda":
            raise AssertionError(f"phase 15b: the trace holds no record of {missing}: {prof}")
        want_type = "H100" if gpu == "cuda" else None
        if first["accelerator_type"] != want_type or second["accelerator_type"] != want_type:
            raise AssertionError(f"phase 15b: current_accelerator_type() "
                                 f"{first['accelerator_type']!r}, {want_type!r} expected")
        res["15b"] = {"trace_kernels": prof, "guard_fired": False,
                      "accelerator_type": first["accelerator_type"]}
        counts_a = [g[0] for g in backend.groups]

        # (c) two workers sharing the card
        loop_config = {"cfg": cfg, "tokens": tokens, "seed": TRAIN_SEED,
                       "steps": PHASE15_MESH_STEPS, "device": None if gpu == "cuda" else gpu}
        backend = CountingBackend(coordinator_port=0)
        t0 = time.perf_counter()
        result = train.JaxTrainer(
            phase15_mesh_loop, train_loop_config=loop_config, jax_backend=backend,
            scaling_config=ScalingConfig(
                num_workers=2, resources_per_worker={"GPU": 0.5} if gpu == "cuda" else None),
            run_config=RunConfig(name="phase15c", storage_path=storage)).fit()
        res["15c_fit_s"] = time.perf_counter() - t0
        if result.error is not None:
            raise AssertionError(f"phase 15c: the run failed: {result.error!r}")
        ranks = _records(result.path, "rank")
        pids += [r["pid"] for r in ranks]
        tol = TT.TRAIN_GOLDEN_TOL["bf16"]["loss"]
        errs = [abs(a - b) for r in ranks for a, b in zip(r["losses"], want_losses)]
        if len(ranks) != 2 or len(errs) != 2 * PHASE15_MESH_STEPS or max(errs) > tol:
            raise AssertionError(f"phase 15c: ranks' losses {[r['losses'] for r in ranks]} "
                                 f"vs 9b's {want_losses[:PHASE15_MESH_STEPS]} (tolerance {tol})")
        if ranks[0]["digests"] != ranks[1]["digests"]:
            differ = [k for k in ranks[0]["digests"]
                      if ranks[0]["digests"][k] != ranks[1]["digests"][k]]
            raise AssertionError(f"phase 15c: leaves differ across the ranks: {differ}")
        res["15c"] = {"losses": [r["losses"] for r in ranks], "max_loss_err": max(errs),
                      "leaves_bit_equal_across_ranks": True,
                      "setup_s": [r["setup_s"] for r in ranks],
                      "first_step_s": [r["step_s"][0] for r in ranks],
                      "step_ms_host_by_rank": [[1e3 * s for s in r["step_s"][1:]]
                                               for r in ranks],
                      "fit_s": res["15c_fit_s"]}
        counts_c = backend.groups[0]
    finally:
        procs = _cluster_procs(c)
        try:
            rt.shutdown()
        finally:
            c.shutdown()
            killed = _reap(procs)
    deadline = time.time() + PHASE15_DEAD_AFTER_S
    while any(_pid_alive(p) for p in pids) and time.time() < deadline:
        time.sleep(0.2)
    alive = [p for p in pids if _pid_alive(p)]
    if alive or killed:
        raise AssertionError(f"phase 15: train workers alive {PHASE15_DEAD_AFTER_S} s after "
                             f"shutdown: {alive}, killed {killed}")
    res["phase_s"] = time.perf_counter() - t_phase

    def summed(groups):
        return {k: sum(g["launches"][k] for g in groups) for k in TRAIN_KERNELS}

    launches_a, launches_c = summed(counts_a), summed(counts_c)
    res["launches"] = {"15a": launches_a, "15a_by_worker": [g["launches"] for g in counts_a],
                       "15c": launches_c, "15c_by_rank": [g["launches"] for g in counts_c]}
    log(f"phase 15 launches: 15a {launches_a}; 15c {launches_c}")
    if gpu == "cuda":
        want = {k: n * PHASE15_STEPS for k, n in TRAIN_LAUNCHES_PER_STEP.items()}
        if launches_a != want:
            raise AssertionError(f"phase 15a: launches {launches_a}, predicted {want}")
        for who, groups in (("15a", counts_a), ("15c", counts_c)):
            for g in groups:
                missing = [k for k in TRAIN_KERNELS if g["launches"][k] == 0]
                if missing:
                    raise AssertionError(f"phase {who}: worker {g['pid']} never launched "
                                         f"{missing}")
                if any(g["tc"][k] != g["launches"][k] for k in ("attention", "attention_bwd")):
                    raise AssertionError(f"phase {who}: worker {g['pid']}: K8/K8' launches "
                                         f"{g['launches']}, on the tensor cores {g['tc']}")
                if g["rows"] != g["launches"]["rope_split_bwd"]:
                    raise AssertionError(f"phase {who}: worker {g['pid']}: K10b' not all in "
                                         "the rows form")
    log(f"phase 15: {json.dumps(res)}")
    return res, launches_a, launches_c


# ------------------------------------------------- phase 16: RLlib and Tune

RL_CU_SOURCE = "ray_tpu_torch/rllib/csrc/rllib_kernels.cu"
#: the RL kernels and the lines of the JAX package each replaces
RL_REPLACES = {
    "sample_actions": "ray_tpu/rllib/policy.py:49",
    "pg_update": "ray_tpu/rllib/policy.py:64",
    "dqn_update": "ray_tpu/rllib/policy.py:150",
}
#: K12's PPO mode replaces this line too (ray_tpu/rllib/policy.py ppo_update)
RL_REPLACES_PPO = "ray_tpu/rllib/policy.py:100"
#: K12 and K13 against their plain versions on the card: losses relative
#: (the batch summed in another order than torch.sum;
#: tests/test_torch_rllib_card.py's CARD_TOL)
RL_CARD_TOL = {"loss_rel": 1e-5}
PHASE16_ITERS = 3
#: tests/test_rllib.py:160's DQN configuration
PHASE16_DQN = dict(algo="dqn", rollout_fragment_length=256, train_batch_size=128,
                   num_updates_per_iter=64, lr=1e-3, learning_starts=1_000,
                   target_sync_every=100, epsilon_decay_steps=4_000)
#: largest first: trials launch in this order, so the rungs see the fast
#: learners first and ASHA has slower ones to stop
PHASE16_TUNE_LRS = (1e-2, 5e-3, 3e-3, 1e-3)
PHASE16_TUNE_ITERS = 4
PHASE16_NODE_CPUS = 12  # 4 trials, each its actor and two runners


def _k11_check(torch, RK, prng, net, obs, key, what, buffers=None):
    """K11 against its plain version on one step: the next key bit for bit,
    the draws equal where the plain version's top-2 gap of logits + noise
    is at least RL_TIE_GAP, logp within RL_LOGP_TOL there. Returns (the
    largest logp error, rows skipped as near-ties, K11's next key)."""
    got = RK.sample_actions(net, obs, key, buffers)
    want = RK.sample_actions_plain(net, obs, key)
    A = net.wp.shape[1]
    bits = prng.split_and_bits(key.cpu(), (len(obs), A))[1]
    with torch.no_grad():
        logits = (net.trunk(torch.as_tensor(obs).to(net.w1.device)) @ net.wp + net.bp).cpu()
    s = torch.sort(prng.gumbel_of_bits(bits) + logits, dim=-1).values
    clean = (s[:, -1] - s[:, -2]) >= RK.RL_TIE_GAP
    err = (got[1] - want[1].cpu()).abs()[clean].max().item() if clean.any() else 0.0
    if not (torch.equal(got[2], want[2]) and torch.equal(got[0][clean], want[0].cpu()[clean])
            and err <= RK.RL_LOGP_TOL):
        raise AssertionError(f"phase 16a: K11 {what} differs from its plain version (keys "
                             f"{got[2].tolist()} {want[2].tolist()}, logp {err:.3e})")
    return err, int((~clean).sum()), got[2]


def _k13_check(torch, RK, pol, dev, B, updates, H=64, A=2, lr=1e-3):
    """K13 against its plain version over `updates` updates at [B, 4] ->
    hidden H -> A, a target sync after the third (DQNLearner.sync_target):
    each update's stats within RL_CARD_TOL["loss_rel"] (the loss and mean
    |td| relative, mean q against mean |q|: its terms have both signs), the
    params and moments after within UPDATE_TOL tensor by tensor (the
    value head bit-equal), and each launch bit-equal to a second launch
    from the same state. Returns the largest |difference| of a stat or a
    param."""
    def clone(net, st):
        c = pol.params_from_numpy(pol.params_to_numpy(net), dev)
        return c, type(st)(st.count, {n: t.clone() for n, t in st.mu.items()},
                           {n: t.clone() for n, t in st.nu.items()})

    opt = pol.make_optimizer(lr)
    net = pol.init_params(np.random.default_rng(B + A), 4, A, H, device=dev)
    tnet = pol.init_params(np.random.default_rng(B + A + 1), 4, A, H, device=dev)
    state = opt.init(net)
    ref, ref_state = clone(net, state)
    ref_t = pol.params_from_numpy(pol.params_to_numpy(tnet), dev)
    rng = np.random.default_rng(B + updates)
    worst = 0.0
    for u in range(updates):
        batch = {"obs": rng.normal(0, 0.5, (B, 4)).astype(np.float32),
                 "actions": rng.integers(0, A, B).astype(np.int32),
                 "rewards": np.ones(B, np.float32),
                 "next_obs": rng.normal(0, 0.5, (B, 4)).astype(np.float32),
                 "dones": (rng.random(B) < 0.1).astype(np.float32)}
        with torch.no_grad():
            q_abs = (ref.trunk(torch.from_numpy(batch["obs"]).to(dev)) @ ref.wp
                     + ref.bp).abs().mean().item()
        twin, twin_state = clone(net, state)
        got = RK.dqn_update(net, tnet, state, opt, batch)
        again = RK.dqn_update(twin, tnet, twin_state, opt, batch)
        want = RK.dqn_update_plain(ref, ref_t, ref_state, opt, batch, 0.99).cpu()
        diff = (got - want).abs()
        worst = max(worst, diff.max().item())
        lim = RL_CARD_TOL["loss_rel"]
        if not (bool((diff[:2] <= lim * want[:2].abs()).all())
                and diff[2].item() <= lim * q_abs):
            raise AssertionError(f"phase 16a: K13 [{B}] update {u}: stats {got.tolist()} "
                                 f"against the plain version's {want.tolist()}")
        same = torch.equal(got, again) and all(
            torch.equal(getattr(net, n), getattr(twin, n))
            and torch.equal(state.mu[n], twin_state.mu[n])
            and torch.equal(state.nu[n], twin_state.nu[n]) for n in RK.PARAM_NAMES)
        if not same:
            raise AssertionError(f"phase 16a: K13 [{B}] update {u}: two launches differ")
        if u == 2:
            with torch.no_grad():
                for t, p in zip(tnet.parameters(), net.parameters()):
                    t.copy_(p)
                for t, p in zip(ref_t.parameters(), ref.parameters()):
                    t.copy_(p)
    bad, got = RK.update_mismatch(net, state, ref, ref_state, updates, lr, RK.DQN_ZERO_GRAD)
    if bad is not None:
        raise AssertionError(f"phase 16a: K13 [{B}] over {updates} updates: {bad} ({got})")
    return max(worst, got["params_max"]), got


def _rl_pg_batch(B, A, seed):
    """A padded PG/PPO batch of B rows at obs 4, the last fifth padding."""
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(0, 0.5, (B, 4)).astype(np.float32),
            "actions": rng.integers(0, A, B).astype(np.int32),
            "returns": rng.uniform(0, 40, B).astype(np.float32),
            "logp_old": np.log(rng.uniform(0.3, 0.7, B)).astype(np.float32),
            "mask": (np.arange(B) < B - B // 5).astype(np.float32)}


def _k12_check(torch, RK, pol, dev, B, H, A, clip, updates=3, lr=3e-3):
    """K12 against its plain version on each of `updates` updates at [B,
    4] -> hidden H -> A (clip None: PG, else PPO), each from the kernel's
    own state (chained, PPO's clip ends and Adam's first step carry ulps
    into later steps): total and vf within RL_CARD_TOL["loss_rel"]
    relative, pg within it of pg_term_scale (a mean of terms of both
    signs), the params and moments after within UPDATE_TOL tensor by
    tensor, and each launch bit-equal to a second launch from the same
    state. Returns (the largest |difference| of a stat or a param, the
    worst measured numbers)."""
    def clone(net, st):
        c = pol.params_from_numpy(pol.params_to_numpy(net), dev)
        return c, type(st)(st.count, {n: t.clone() for n, t in st.mu.items()},
                           {n: t.clone() for n, t in st.nu.items()})

    opt = pol.make_optimizer(lr)
    net = pol.init_params(np.random.default_rng(B + H + A), 4, A, H, device=dev)
    state = opt.init(net)
    worst, lim = 0.0, RL_CARD_TOL["loss_rel"]
    measured = {"params_max": 0.0, "params_share": 1.0, "moments_rel": 0.0}
    what = f"K12 [{B}] hidden {H} A {A} {'pg' if clip is None else 'ppo'}"
    for u in range(updates):
        batch = _rl_pg_batch(B, A, B + H + u)
        ref, ref_state = clone(net, state)
        twin, twin_state = clone(net, state)
        scale = RK.pg_term_scale(ref, batch, clip)
        got = RK.pg_update(net, state, opt, batch, clip)
        again = RK.pg_update(twin, twin_state, opt, batch, clip)
        want = RK.pg_update_plain(ref, ref_state, opt, batch, clip).cpu()
        diff = (got - want).abs()
        worst = max(worst, diff.max().item())
        if not (diff[0].item() <= lim * abs(want[0].item())
                and diff[2].item() <= lim * abs(want[2].item())
                and diff[1].item() <= lim * scale):
            raise AssertionError(f"phase 16a: {what} update {u}: stats {got.tolist()} against "
                                 f"the plain version's {want.tolist()} (pg's scale {scale})")
        same = torch.equal(got, again) and all(
            torch.equal(getattr(net, n), getattr(twin, n))
            and torch.equal(state.mu[n], twin_state.mu[n])
            and torch.equal(state.nu[n], twin_state.nu[n]) for n in RK.PARAM_NAMES)
        if not same:
            raise AssertionError(f"phase 16a: {what} update {u}: two launches differ")
        bad, got = RK.update_mismatch(net, state, ref, ref_state, 1, lr)
        if bad is not None:
            raise AssertionError(f"phase 16a: {what} update {u}: {bad} ({got})")
        measured = {k: (min if k == "params_share" else max)(v, got[k])
                    for k, v in measured.items()}
    return max(worst, measured["params_max"]), measured


def _k12_ms_at(torch, RK, pol, dev, B, H, clip, A=2):
    """K12's CUDA-event ms (its staging copy and its launch) at [B, 4] ->
    H -> A, and its plain version's, each from a state of its own."""
    opt = pol.make_optimizer(3e-3)
    batch = _rl_pg_batch(B, A, 7)
    net = pol.init_params(np.random.default_rng(1), 4, A, H, device=dev)
    plain = pol.params_from_numpy(pol.params_to_numpy(net), dev)
    state, plain_state = opt.init(net), opt.init(plain)
    ms = time_ms(torch, lambda: RK.pg_update(net, state, opt, batch, clip, sync=False),
                 reps=21)
    plain_ms = time_ms(torch, lambda: RK.pg_update_plain(plain, plain_state, opt, batch, clip),
                       reps=21)
    return ms, plain_ms, net, state, batch


def _k13_ms_at(torch, RK, pol, dev, B, qnet, tnet, opt):
    """K13's CUDA-event ms at batch B (the default train_batch_size passes
    in tiles), from a copy of qnet's state."""
    net = pol.params_from_numpy(pol.params_to_numpy(qnet), dev)
    state = opt.init(net)
    rng = np.random.default_rng(B)
    batch = {"obs": rng.normal(0, 0.5, (B, 4)).astype(np.float32),
             "actions": rng.integers(0, net.wp.shape[1], B).astype(np.int32),
             "rewards": np.ones(B, np.float32),
             "next_obs": rng.normal(0, 0.5, (B, 4)).astype(np.float32),
             "dones": (rng.random(B) < 0.1).astype(np.float32)}
    return time_ms(torch, lambda: RK.dqn_update(net, tnet, state, opt, batch, sync=False),
                   reps=21)


def phase16a_rl_kernels(torch, RK, prng, dev):
    """K11-K13 against their plain versions on the card. K11, the runner's
    whole step, at B 1, 3, 64 x hidden 32, 64, 128 x A 2, 7 (4 keys each)
    and over a 512-step key chain at the main path's [1, 4] -> 64 -> 2 with
    a runner's buffers: keys bit for bit, draws outside RL_TIE_GAP, logp
    within RL_LOGP_TOL, two launches bit-equal; K12, the whole PG/PPO
    update, in both modes at B 2 048 (the default train_batch_size, hidden
    64, A 2), B 5 and 128, A 7, hidden 32, and in tiles at hidden 128, each
    over 3 updates (_k12_check); K13, the whole DQN update, at B 32
    and 128 (hidden 64, A 2), B 32 at A 7, and in tiles at B 2 048 (the
    default train_batch_size) and at hidden 128, B 128, each over 1 and 5
    updates (_k13_check). Then each timed by CUDA
    events at the main path's shapes (K11 [1, 4] hidden 64 A 2, K12 at
    batch 2 048, hidden 64, A 2 in PPO's mode (PG's, batch 128 and hidden
    128's tiles beside it), K13 at batch 128, hidden 64, A 2: K12's and
    K13's with their staging copy) beside its plain version, with its
    bound."""
    from ray_tpu_torch.rllib import policy as pol

    rec = {}
    worst, skipped, rows = 0.0, 0, 0
    for B in (1, 3, 64):
        for H in (32, 64, 128):
            for A in (2, 7):
                net = pol.init_params(np.random.default_rng(B * A + H), 4, A, H, device=dev)
                rng = np.random.default_rng(B * A)
                for seed in range(4):
                    obs = rng.normal(0, 1.0, (B, 4)).astype(np.float32)
                    key = prng.PRNGKey(seed * 7919 + B, device=dev)
                    err, n, _ = _k11_check(torch, RK, prng, net, obs, key,
                                           f"[{B}, 4] hidden {H} A {A} seed {seed}")
                    a, b = RK.sample_actions(net, obs, key), RK.sample_actions(net, obs, key)
                    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                            and torch.equal(a[2], b[2])):
                        raise AssertionError(f"phase 16a: K11 [{B}, 4] hidden {H} A {A}: "
                                             "two launches differ")
                    worst, skipped, rows = max(worst, err), skipped + n, rows + B
    net = pol.init_params(np.random.default_rng(0), 4, 2, 64, device=dev)
    buffers = RK.SampleBuffers(dev, 1)
    rng = np.random.default_rng(16)
    k_card = k_plain = prng.PRNGKey(3_000_010, device=dev)
    for i in range(512):
        obs = rng.normal(0, 0.5, (1, 4)).astype(np.float32)
        err, n, k_card = _k11_check(torch, RK, prng, net, obs, k_card, f"chain step {i}",
                                    buffers)
        k_plain = RK.sample_actions_plain(net, obs, k_plain)[2]
        if not torch.equal(k_card, k_plain):
            raise AssertionError(f"phase 16a: K11's key chain differs from plain at step {i}")
        worst, skipped, rows = max(worst, err), skipped + n, rows + 1
    if skipped > 0.001 * rows:
        raise AssertionError(f"phase 16a: K11: {skipped} of {rows} draws near a tie")
    rec["sample_actions"] = {"max_abs_err": worst, "near_ties_skipped": skipped, "rows": rows}
    worst, detail = 0.0, {}
    for B, H, A in ((2048, 64, 2), (5, 64, 2), (128, 64, 2), (2048, 64, 7), (2048, 32, 2),
                    (2048, 128, 2)):
        for clip in (None, RK.PPO_CLIP):
            err, detail[f"B{B}_H{H}_A{A}_{'pg' if clip is None else 'ppo'}"] = _k12_check(
                torch, RK, pol, dev, B, H, A, clip)
            worst = max(worst, err)
    rec["pg_update"] = {"max_abs_err": worst, "against_plain": detail}
    worst, detail = 0.0, {}
    for B, H, A in ((32, 64, 2), (128, 64, 2), (32, 64, 7), (2048, 64, 2), (128, 128, 2)):
        for updates in (1, 5):
            err, detail[f"B{B}_H{H}_A{A}_x{updates}"] = _k13_check(torch, RK, pol, dev, B,
                                                                   updates, H, A)
            worst = max(worst, err)
    rec["dqn_update"] = {"max_abs_err": worst, "against_plain": detail}

    # times at the main path's shapes (launches here are not the main path's)
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    O, H, A = 4, 64, 2
    obs = np.random.default_rng(1).normal(0, 0.5, (1, O)).astype(np.float32)
    key = prng.PRNGKey(1, device=dev)
    policy = [getattr(net, n) for n in RK.POLICY_NAMES]
    trunk_ops = lambda B: 2 * B * (O * H + H * H + H * A)  # noqa: E731
    rec["sample_actions"].update(
        ms=time_ms(torch, lambda: RK.sample_actions(net, obs, key, buffers, sync=False),
                   reps=21),
        plain_ms=time_ms(torch, lambda: RK.sample_actions_plain(net, obs, key), reps=21),
        # the weights, obs and key read; actions, logp and the next key written
        bound=bound(nb(*policy) + obs.nbytes + 16 + 1 * 8 + 16,
                    trunk_ops(1) + 3 * 20 * 4 + 16 * A),
        library_ms=None, shape=[1, O, H, A])
    B = 2048
    ms, plain_ms, pnet, pstate, pbatch = _k12_ms_at(torch, RK, pol, dev, B, H, RK.PPO_CLIP)
    params = [getattr(pnet, n) for n in RK.PARAM_NAMES]
    moments = [pstate.mu[n] for n in RK.PARAM_NAMES] + [pstate.nu[n] for n in RK.PARAM_NAMES]
    # read: params, moments, the batch; written: params, moments, stats.
    # Operations: the trunk and both heads, the backward's products (d[wp |
    # wv], dz2, d w2, dz1, d w1; the bias sums, tanh's and the loss head apart)
    head = H * (A + 1)
    pg_ops = 2 * B * (O * H + H * H + head) + 2 * B * (head + head + H * H + H * H + O * H)
    rec["pg_update"].update(
        ms=ms, plain_ms=plain_ms,
        bound=bound(2 * nb(*params, *moments) + sum(a.nbytes for a in pbatch.values()) + 12,
                    pg_ops),
        library_ms=None, shape=[B, O, H, A], mode="ppo",
        cluster=list(RK.pg_plan(B, O, H, A)),
        ms_batch_128=_k12_ms_at(torch, RK, pol, dev, 128, H, RK.PPO_CLIP)[0:2],
        ms_hidden_128_tiled=_k12_ms_at(torch, RK, pol, dev, B, 128, RK.PPO_CLIP)[0:2])
    rec["pg_update"]["ms_pg_mode"], rec["pg_update"]["ms_plain_pg_mode"] = _k12_ms_at(
        torch, RK, pol, dev, B, H, None)[0:2]
    B = 128
    opt = pol.make_optimizer(1e-3)
    qnet = pol.init_params(np.random.default_rng(3), O, A, H, device=dev)
    tnet = pol.init_params(np.random.default_rng(4), O, A, H, device=dev)
    state = opt.init(qnet)
    rng = np.random.default_rng(5)
    batch = {"obs": rng.normal(0, 0.5, (B, O)).astype(np.float32),
             "actions": rng.integers(0, A, B).astype(np.int32),
             "rewards": np.ones(B, np.float32),
             "next_obs": rng.normal(0, 0.5, (B, O)).astype(np.float32),
             "dones": (rng.random(B) < 0.1).astype(np.float32)}
    ms = time_ms(torch, lambda: RK.dqn_update(qnet, tnet, state, opt, batch, sync=False),
                 reps=21)
    plain_net = pol.params_from_numpy(pol.params_to_numpy(qnet), dev)
    plain_state = opt.init(plain_net)
    plain_ms = time_ms(torch, lambda: RK.dqn_update_plain(plain_net, tnet, plain_state, opt,
                                                          batch, 0.99), reps=21)
    params = [getattr(qnet, n) for n in RK.PARAM_NAMES]
    moments = [state.mu[n] for n in RK.PARAM_NAMES] + [state.nu[n] for n in RK.PARAM_NAMES]
    target = [getattr(tnet, n) for n in RK.POLICY_NAMES]
    batch_bytes = sum(a.nbytes for a in batch.values())
    # read: params, moments, target, batch; written: params, moments, stats.
    # Operations: the three trunks and heads, the backward's products
    # (d wp, dz2, d w2, dz1, d w1; the bias sums and tanh's apart)
    ops = 3 * trunk_ops(B) + 2 * B * (H * A + H * A + H * H + H * H + O * H)
    rec["dqn_update"].update(
        ms=ms, plain_ms=plain_ms,
        bound=bound(2 * nb(*params, *moments) + nb(*target) + batch_bytes + 12, ops),
        library_ms=None, shape=[B, O, H, A],
        smem_bytes=RK.dqn_smem_bytes(RK.dqn_tile_rows(B, O, H, A), O, H, A),
        ms_batch_2048=_k13_ms_at(torch, RK, pol, dev, 2048, qnet, tnet, opt))
    for name, r in rec.items():
        log(f"phase 16a {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.2e} ms by {r['bound'][1]}), max |err| {r['max_abs_err']:.3e}")
    log(f"phase 16a dqn_update at batch 2048 (in tiles): {rec['dqn_update']['ms_batch_2048']:.4f}"
        f" ms; against plain {json.dumps(rec['dqn_update']['against_plain'])}")
    r = rec["pg_update"]
    log(f"phase 16a pg_update: PPO {r['ms']:.4f} ms, PG {r['ms_pg_mode']:.4f} ms (plain "
        f"{r['plain_ms']:.4f}, {r['ms_plain_pg_mode']:.4f}) at batch 2048 on a cluster of "
        f"{r['cluster']}; batch 128 {r['ms_batch_128']}, hidden 128 in tiles "
        f"{r['ms_hidden_128_tiled']} (ms, plain ms); against plain "
        f"{json.dumps(r['against_plain'])}")
    return rec


def _rl_iterations(algo, n):
    """n iterations of an Algorithm: each one's sample and update s (host
    clock) and its losses; the algorithm is stopped after."""
    out = []
    try:
        for _ in range(n):
            r = algo.train()
            out.append({k: r[k] for k in ("training_iteration", "episode_reward_mean",
                                          "num_env_steps_sampled", "sample_time_s",
                                          "update_time_s") if k in r}
                       | {k: r[k] for k in ("total_loss", "num_updates") if k in r})
    finally:
        algo.stop()
    return out


def _rl_fragment_check(torch, RK, prng, gpu):
    """One runner's 128 steps from one seed on the card and on the CPU
    (the plain K11): equal up to the first step where the CPU's top-2 gap
    of logits + Gumbel noise is under RL_TIE_GAP; then the card's learner
    and the CPU's on that fragment, total_loss within 1e-5 relative."""
    from ray_tpu_torch.rllib import policy as pol
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    from ray_tpu_torch.rllib.learner import Learner

    weights = pol.params_to_numpy(pol.init_params(np.random.default_rng(0), 4, 2, 64,
                                                  device="cpu"))
    card = EnvRunner("CartPole-v1", seed=0, rollout_fragment_length=128,
                     device=gpu).sample(weights)
    cpu = EnvRunner("CartPole-v1", seed=0, rollout_fragment_length=128,
                    device="cpu").sample(weights)
    net = pol.params_from_numpy(weights, "cpu")
    key = prng.PRNGKey(1)
    upto = 128
    for i in range(128):
        key, bits = prng.split_and_bits(key, (1, 2))
        s = np.sort((prng.gumbel_of_bits(bits)
                     + pol.action_logits(net, cpu["obs"][i:i + 1])).numpy()[0])
        if s[-1] - s[-2] < RK.RL_TIE_GAP:
            upto = i
            break
    for k in ("obs", "actions"):
        if not np.array_equal(card[k][:upto], cpu[k][:upto]):
            bad = int(np.flatnonzero((card[k][:upto] != cpu[k][:upto]).reshape(upto, -1)
                                     .any(1))[0])
            raise AssertionError(f"phase 16b: the card's fragment's {k} differs from the "
                                 f"CPU's at step {bad} (near-tie-free up to {upto})")
    # the logits' last bits differ between K11's sums on the card and torch's
    # products on the CPU: RL_LOGP_TOL, as K11 against its plain version
    logp_err = float(np.abs(card["logp_old"][:upto] - cpu["logp_old"][:upto]).max())
    if not logp_err <= RK.RL_LOGP_TOL:
        raise AssertionError(f"phase 16b: the card's logp differs from the CPU's by {logp_err}")
    res = {"fragment_steps_equal": upto, "logp_max_abs_err": logp_err}
    if upto == 128:
        got = Learner(4, 2, train_batch_size=128, device=gpu).update(card)["total_loss"]
        want = Learner(4, 2, train_batch_size=128, device="cpu").update(cpu)["total_loss"]
        if not abs(got - want) <= 1e-5 * abs(want):
            raise AssertionError(f"phase 16b: the card's update's total_loss {got} vs the "
                                 f"CPU's {want}")
        res["total_loss_card_cpu"] = [got, want]
    return res


class _CardCalls:
    """Counts, while started, the calls of AdamW.update, PolicyNet.trunk and
    policy.q_values made on the card: each is patched with a counting
    wrapper (the runners are threads of this process in a local runtime)."""

    def __init__(self):
        self.counts = {"adamw_update": 0, "trunk": 0, "q_values": 0}
        self._lock = threading.Lock()
        self._saved = []

    def start(self) -> None:
        from ray_tpu_torch.parallel.tpu_train import AdamW
        from ray_tpu_torch.rllib import policy as pol

        for owner, name, label, module_at in ((AdamW, "update", "adamw_update", 1),
                                              (pol.PolicyNet, "trunk", "trunk", 0),
                                              (pol, "q_values", "q_values", 0)):
            fn = getattr(owner, name)

            def counting(*args, _fn=fn, _label=label, _at=module_at, **kwargs):
                if args[_at].device.type == "cuda":
                    with self._lock:
                        self.counts[_label] += 1
                return _fn(*args, **kwargs)

            self._saved.append((owner, name, fn))
            setattr(owner, name, counting)

    def stop(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()


def phase16b_rllib(torch, RK, prng, gpu="cuda"):
    """RLlib's Algorithm at the reference's full default width (CartPole-v1,
    hidden 64, 2 runners x 512 steps, train_batch_size 2048) in a local
    runtime: PHASE16_ITERS iterations of PG and of PPO with the learner
    and the runners on the card, PPO again with the runners on the CPU,
    and DQN (tests/test_rllib.py:160's configuration) past learning_starts
    into its updates, runners on the card; the RL kernels' counters from 0
    over the four runs, and beside them the calls of AdamW.update, of the
    policy's trunk and of the DQN runners' q_values on the card
    (_CardCalls): K11's runner steps and K12's and K13's updates make none,
    so AdamW.update never runs on the card and the trunk only in a DQN
    runner's greedy step. Then, outside the window, one runner's fragment
    and one update on the card against the CPU's, and a runner step's host
    time by part and a PPO and a DQN update's ms
    (ray_tpu_torch/scripts/profile_rllib.py). Returns (results,
    launches)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import AlgorithmConfig

    t_phase = time.perf_counter()
    overrides = {} if gpu == "cuda" else {"scheduler_device": gpu}
    rt.init(num_cpus=8, _system_config=overrides)
    res = {}
    calls = _CardCalls()
    try:
        RK.reset_launch_counts()
        calls.start()
        on_card = dict(learner_device=gpu, env_runner_device=gpu)
        res["pg"] = _rl_iterations(AlgorithmConfig(algo="pg", **on_card).build(),
                                   PHASE16_ITERS)
        res["ppo"] = _rl_iterations(AlgorithmConfig(algo="ppo", **on_card).build(),
                                    PHASE16_ITERS)
        res["ppo_runners_on_cpu"] = _rl_iterations(
            AlgorithmConfig(algo="ppo", learner_device=gpu, env_runner_device="cpu").build(),
            PHASE16_ITERS)
        res["dqn"] = _rl_iterations(AlgorithmConfig(**PHASE16_DQN, **on_card).build(),
                                    PHASE16_ITERS)
        launches = RK.launch_counts()
    finally:
        calls.stop()
        rt.shutdown()
    for name, its in res.items():
        for r in its:
            if not np.isfinite(r.get("total_loss", 0.0)):
                raise AssertionError(f"phase 16b: {name}: a loss is not finite: {r}")
        log(f"phase 16b {name}: " + "; ".join(
            f"it {r['training_iteration']}: sample {r['sample_time_s']:.3f} s, update "
            f"{r['update_time_s']:.4f} s, reward {r['episode_reward_mean']:.1f}" for r in its))
    if res["dqn"][-1].get("num_updates", 0) == 0:
        raise AssertionError(f"phase 16b: DQN never updated: {res['dqn']}")
    dqn_updates = res["dqn"][-1]["num_updates"]
    steps = 2 * 512
    # K11 a step of the on-card PG and PPO runners, K12 an update of PG and
    # both PPO runs, K13 a DQN update
    want = {"sample_actions": 2 * PHASE16_ITERS * steps if gpu == "cuda" else 0,
            "pg_update": 3 * PHASE16_ITERS if gpu == "cuda" else 0,
            "dqn_update": dqn_updates if gpu == "cuda" else 0}
    if launches != want:
        raise AssertionError(f"phase 16b: RL kernel launches {launches}, predicted {want}")
    if gpu == "cuda" and not all(launches.values()):
        raise AssertionError(f"phase 16b: an RL kernel never launched: {launches}")
    n = calls.counts
    if n["adamw_update"] != 0 or n["trunk"] != n["q_values"]:
        raise AssertionError(f"phase 16b: on the card {n}: AdamW.update ran, or the trunk "
                             "outside the DQN runners' q_values")
    res["card_calls"] = n
    res["check"] = _rl_fragment_check(torch, RK, prng, gpu)
    if gpu == "cuda":
        from ray_tpu_torch.scripts.profile_rllib import dqn_updates as dqn_ms, \
            pg_updates as pg_ms, runner_step_split

        res["runner_step_split"] = runner_step_split(512)
        res["pg_update_host"] = pg_ms(64)
        res["dqn_update_host"] = dqn_ms(64)
        split = res["runner_step_split"]
        parts = {k: round(v, 1) for k, v in split["us_a_step"].items()}
        log(f"phase 16b: a runner step's host us by part {json.dumps(parts)}, "
            f"a PPO update {res['pg_update_host']['update_ms_median']:.4f} ms, "
            f"a DQN update {res['dqn_update_host']['update_ms_median']:.4f} ms")
    res["phase_s"] = time.perf_counter() - t_phase
    res["launches"] = launches
    log(f"phase 16b: {json.dumps(res)}")
    return res, launches


def phase16_trial(config):
    """16c's trainable: PPO at the default width with the learner on the
    trial's device and the runners on the CPU; a report an iteration with
    the trial worker's RL kernel counters."""
    import os as _os

    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib import AlgorithmConfig, rllib_kernels as RK

    RK.reset_launch_counts()
    algo = AlgorithmConfig(algo="ppo", lr=config["lr"], learner_device=config["device"],
                           env_runner_device="cpu").build()
    try:
        for _ in range(config["iters"]):
            r = algo.train()
            tune.report({"episode_reward_mean": r["episode_reward_mean"],
                         "total_loss": r["total_loss"], "sample_time_s": r["sample_time_s"],
                         "update_time_s": r["update_time_s"], "pid": _os.getpid(),
                         "launches": RK.launch_counts()})
    finally:
        algo.stop()


def phase16c_tune(gpu="cuda"):
    """A Tuner with ASHA (grace 1, reduction 2, max_t PHASE16_TUNE_ITERS)
    over PHASE16_TUNE_LRS, PPO trials asking {"CPU": 1, "GPU": 0.25}, in a
    Cluster of its own with one node offering {"GPU": 1}: every trial
    reports, the sweep finishes without an error, each trial's learner
    launched K12, and no worker process is alive PHASE15_DEAD_AFTER_S after
    shutdown(). Returns the results."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.air import RunConfig
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.config import Config

    t_phase = time.perf_counter()
    overrides = {"jax_policy_min_cells": 0}
    if gpu != "cuda":
        overrides["scheduler_device"] = gpu
    config = Config(overrides)
    _shm_room(1, config.object_store_memory_bytes, phase="16")
    storage = tempfile.mkdtemp(prefix="phase16_")
    c = Cluster(config=config)
    procs = []
    try:
        c.add_node(num_cpus=PHASE16_NODE_CPUS, node_id="node-rl", resources={"GPU": 1})
        c.wait_for_nodes(1, timeout=60)
        rt.init(address=c.address)
        t0 = time.perf_counter()
        grid = tune.Tuner(
            phase16_trial,
            param_space={"lr": tune.grid_search(list(PHASE16_TUNE_LRS)),
                         "iters": PHASE16_TUNE_ITERS, "device": gpu},
            tune_config=tune.TuneConfig(
                metric="episode_reward_mean", mode="max",
                scheduler=tune.ASHAScheduler(max_t=PHASE16_TUNE_ITERS, grace_period=1,
                                             reduction_factor=2),
                resources_per_trial={"CPU": 1, "GPU": 0.25} if gpu == "cuda" else {"CPU": 1}),
            run_config=RunConfig(name="phase16c", storage_path=storage)).fit()
        fit_s = time.perf_counter() - t0
        procs = _cluster_procs(c)
    finally:
        procs = procs or _cluster_procs(c)
        try:
            rt.shutdown()
        finally:
            c.shutdown()
            killed = _reap(procs, timeout=PHASE15_DEAD_AFTER_S)
    pids = [p.pid for p in procs]
    deadline = time.time() + PHASE15_DEAD_AFTER_S
    while any(_pid_alive(p) for p in pids) and time.time() < deadline:
        time.sleep(0.2)
    alive = [p for p in pids if _pid_alive(p)]
    if alive or killed:
        raise AssertionError(f"phase 16c: workers alive {PHASE15_DEAD_AFTER_S} s after "
                             f"shutdown: {alive}, killed {killed}")
    if grid.errors or len(grid) != len(PHASE16_TUNE_LRS):
        raise AssertionError(f"phase 16c: {len(grid)} trials, errors {grid.errors}")
    trials = []
    for r in grid:
        h = r.metrics_history
        if not h:
            raise AssertionError(f"phase 16c: a trial reported nothing: {r.metrics}")
        trials.append({"lr": r.metrics["config"]["lr"], "iterations": len(h),
                       "reward": [m["episode_reward_mean"] for m in h],
                       "sample_s": [m["sample_time_s"] for m in h],
                       "update_s": [m["update_time_s"] for m in h],
                       "launches": h[-1]["launches"]})
        want = len(h) if gpu == "cuda" else 0
        if h[-1]["launches"]["pg_update"] != want:
            raise AssertionError(f"phase 16c: trial lr {trials[-1]['lr']}: K12 launched "
                                 f"{h[-1]['launches']['pg_update']} times in {len(h)} "
                                 "iterations")
    stopped = sum(t["iterations"] < PHASE16_TUNE_ITERS for t in trials)
    best = grid.get_best_result()
    res = {"trials": trials, "stopped_early": stopped, "fit_s": fit_s,
           "workers": len(pids), "best_lr": best.metrics["config"]["lr"],
           "phase_s": time.perf_counter() - t_phase}
    log(f"phase 16c: {json.dumps(res)}")
    return res


# ------------------------------------ phase 17: Data, Workflow, the host utilities

PHASE17_ROWS = 64
PHASE17_BLOCKS = 8
PHASE17_BATCH = 8
PHASE17_POOL = 2
PHASE17_TOKEN_SEED = 170  # 17a's tokens [64, 2048]
PHASE17_TRAIN_TOKEN_SEED = 171  # 17b's tokens [64, 2049]
PHASE17_SHUFFLE_SEED = 24
PHASE17_HOST_SEED = 172  # 17c's and 17d's token batches
PHASE17_HOST_BATCHES = 4
PHASE17_BUDGET_S = 150.0
PHASE17_NO_ARROW_ARG = "--phase17a-no-arrow"
# the forward's kernels a forward call launches (6 layers): K8 one a block,
# K10a two a block and ln_f, K10b one a block
PHASE17_FORWARD_KERNELS = ("attention", "rmsnorm", "rope_split")
_PHASE17_MODELS = {}  # (config, device) -> (model, fwd): this process's forward
_PHASE17_MODELS_LOCK = threading.Lock()
_PHASE17_CALLS = []  # Predictor's set-up seconds and calls' ms, this process's


def _phase17_config(PT, cfg_kw):
    """The flagship TransformerConfig() for None, else a small one (the
    rehearsal on the CPU; its dtype by name)."""
    if cfg_kw is None:
        return PT.TransformerConfig()
    import torch

    kw = dict(cfg_kw)
    kw["dtype"] = getattr(torch, kw.pop("dtype", "bfloat16"))
    return PT.TransformerConfig(**kw)


def _phase17_weights(PT, cfg):
    """The weights from the golden's numpy seed; at the flagship's config
    their checksum is held to the golden's first, as 6b does."""
    golden = np.load(GOLDEN_PATH)
    tree = PT.numpy_params(cfg, int(golden["weight_seed"]))
    if cfg == PT.TransformerConfig():
        checksum = PT.weights_checksum(tree)
        if checksum != str(golden["checksum"]):
            raise AssertionError(f"phase 17: numpy_params gave other weights than the "
                                 f"golden's (checksum {checksum[:16]})")
    return tree


def _phase17_model(cfg_kw, device):
    """This process's forward at cfg_kw on device, built once (weights from
    the golden's seed); phase 17 seeds it with 6b's model on the card."""
    from ray_tpu_torch.models import transformer as PT
    from ray_tpu_torch.parallel import make_forward_step

    key = (json.dumps(cfg_kw, sort_keys=True), str(device))
    with _PHASE17_MODELS_LOCK:
        if key not in _PHASE17_MODELS:
            import torch

            cfg = _phase17_config(PT, cfg_kw)
            dev = torch.device(device)
            model = PT.params_from_numpy(_phase17_weights(PT, cfg), cfg, device=dev)
            _PHASE17_MODELS[key] = (model, make_forward_step(cfg, dev))
        return _PHASE17_MODELS[key]


def _last_position(logits):
    """Per row the argmax of the last position's logits and the float64 sum
    of that row's last logits."""
    last = logits[:, -1].float().cpu().numpy()
    return last.argmax(-1).astype(np.int64), last.astype(np.float64).sum(-1)


class Predictor:
    """17a's map_batches class: one instance an actor of the pool, which
    makes the flagship's weights itself from the golden's seed (checksum
    held to the golden's) and runs make_forward_step on the card."""

    def __init__(self, cfg_kw, device):
        import torch

        from ray_tpu_torch.models import transformer as PT
        from ray_tpu_torch.parallel import make_forward_step

        t0 = time.perf_counter()
        cfg = _phase17_config(PT, cfg_kw)
        dev = torch.device(device)
        self.model = PT.params_from_numpy(_phase17_weights(PT, cfg), cfg, device=dev)
        self.fwd = make_forward_step(cfg, dev)
        _PHASE17_CALLS.append(("setup_s", time.perf_counter() - t0))

    def __call__(self, batch):
        t0 = time.perf_counter()
        pred, total = _last_position(self.fwd(self.model, batch["tokens"]))
        _PHASE17_CALLS.append(("call_ms", 1e3 * (time.perf_counter() - t0)))
        return {"pred": pred, "logit_sum": total}


def _columns(ds):
    """A dataset's columns, its batches concatenated in order."""
    batches = list(ds.iter_batches(batch_size=PHASE17_BATCH))
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def _phase17a_tokens(vocab, seq):
    return np.random.default_rng(PHASE17_TOKEN_SEED).integers(
        0, vocab, (PHASE17_ROWS, seq)).astype(np.int32)


def phase17a_pipeline(data, tokens, cfg_kw, device):
    """17a's pipeline: the tokens in 8 blocks, the Predictor on a pool of 2
    actors, 8-row batches; materialized once, then sorted and grouped.
    Returns (the 8 batches as the pipeline cut them, the output's columns,
    sort("pred")'s columns, groupby("pred").count() as a dict, seconds of
    the map_batches run)."""
    base = data.from_numpy(tokens, column="tokens").repartition(PHASE17_BLOCKS)
    batches = [b["tokens"] for b in base.iter_batches(batch_size=PHASE17_BATCH)]
    t0 = time.perf_counter()
    out = base.map_batches(Predictor, compute=data.ActorPoolStrategy(size=PHASE17_POOL),
                           batch_size=PHASE17_BATCH,
                           fn_constructor_args=(cfg_kw, device)).materialize()
    data_s = time.perf_counter() - t0
    got = _columns(out)
    srt = _columns(out.sort("pred"))
    counts = {r["pred"]: r["count"] for r in out.groupby("pred").count().take_all()}
    return batches, got, srt, counts, data_s


def phase17a_no_arrow_main() -> int:
    """17a's pipeline in a process where pyarrow and pandas cannot be
    imported (chip_smoke.py --phase17a-no-arrow '<json>'): prints its
    results as one JSON line."""
    sys.modules["pyarrow"] = None
    sys.modules["pandas"] = None
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    args = json.loads(sys.argv[2])
    tokens = _phase17a_tokens(args["vocab"], args["seq"])
    if args["device"].startswith("cuda"):
        rt.init(num_cpus=8)
    else:
        rt.init(num_cpus=8, _system_config={"scheduler_device": "cpu"})
    try:
        _, got, srt, counts, _ = phase17a_pipeline(data, tokens, args["cfg_kw"], args["device"])
    finally:
        rt.shutdown()
    print(json.dumps({"pred": got["pred"].tolist(), "logit_sum": got["logit_sum"].tolist(),
                      "sorted_pred": srt["pred"].tolist(),
                      "counts": {str(k): v for k, v in counts.items()},
                      "pyarrow": sys.modules.get("pyarrow") is not None,
                      "pandas": sys.modules.get("pandas") is not None}), flush=True)
    return 0


def phase17a_data(torch, MK, ctx, cfg_kw=None, seq=2048, gpu="cuda"):
    """Batch inference through Data in a local runtime (the default config
    on the card): from_numpy(tokens [64, seq]).repartition(8).map_batches(
    Predictor, ActorPoolStrategy(size=2), batch_size=8), with the model
    kernels' counters from 0 over the map_batches run; each row's argmax
    and float64 logit sum bit-equal to 6b's forward on the same 8-row
    batches, sort("pred") equal to numpy's stable argsort of them and
    groupby("pred").count() to numpy's counts, and the window's launches
    8 forwards' worth (every K8 on the tensor cores). Where pyarrow or
    pandas is installed, the pipeline runs again in a process that cannot
    import them, bit-equal. Returns (results, launches)."""
    import importlib.util

    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    t_part = time.perf_counter()
    cfg, fwd, model = ctx["cfg"], ctx["fwd"], ctx["model"]
    dev = model.device
    tokens = _phase17a_tokens(cfg.vocab_size, seq)
    rt.init(num_cpus=8, _system_config={} if gpu == "cuda" else {"scheduler_device": gpu})
    try:
        del _PHASE17_CALLS[:]
        MK.reset_launch_counts()
        batches, got, srt, counts, data_s = phase17a_pipeline(data, tokens, cfg_kw, str(dev))
        launches, tc = MK.launch_counts(), MK.tc_launch_counts()
        calls = list(_PHASE17_CALLS)
    finally:
        rt.shutdown()
    # the direct forward on the same batches, outside the window
    MK.reset_launch_counts()
    direct = [_last_position(fwd(model, b)) for b in batches[:1]]
    per_forward = MK.launch_counts()
    direct += [_last_position(fwd(model, b)) for b in batches[1:]]
    pred = np.concatenate([d[0] for d in direct])
    total = np.concatenate([d[1] for d in direct])
    if not (np.array_equal(got["pred"], pred) and np.array_equal(got["logit_sum"], total)):
        bad = int((got["pred"] != pred).sum() + (got["logit_sum"] != total).sum())
        raise AssertionError(f"phase 17a: {bad} outputs of the pipeline differ from the "
                             "direct forward's on the same batches")
    order = np.argsort(pred, kind="stable")
    if not (np.array_equal(srt["pred"], pred[order])
            and np.array_equal(srt["logit_sum"], total[order])):
        raise AssertionError("phase 17a: sort('pred') differs from numpy's stable argsort")
    keys, n = np.unique(pred, return_counts=True)
    if counts != dict(zip(keys.tolist(), n.tolist())):
        raise AssertionError(f"phase 17a: groupby('pred').count() {counts} differs from numpy")
    n_batches = len(batches)
    want = {k: n_batches * per_forward[k] for k in PHASE17_FORWARD_KERNELS}
    got_l = {k: launches[k] for k in PHASE17_FORWARD_KERNELS}
    if gpu == "cuda" and (got_l != want or tc["attention"] != launches["attention"]
                          or min(got_l.values()) == 0):
        raise AssertionError(f"phase 17a: the pool's launches {got_l} (tensor cores {tc}), "
                             f"{n_batches} forwards' {want} predicted")
    setup = [v for k, v in calls if k == "setup_s"]
    call_ms = [v for k, v in calls if k == "call_ms"]
    res = {"rows": PHASE17_ROWS, "seq": seq, "batches": n_batches,
           "bit_equal_direct": True, "sort_equal_numpy": True, "groupby_equal_numpy": True,
           "groups": len(counts), "map_batches_s": data_s,
           "rows_per_s": PHASE17_ROWS / data_s,
           "tokens_per_s": PHASE17_ROWS * seq / data_s,
           "actor_setup_s": setup, "call_ms_host": call_ms,
           "rows_per_s_after_setup": PHASE17_ROWS / max(data_s - max(setup), 1e-9),
           "launches": got_l, "launches_tc": tc["attention"]}
    blocked = [m for m in ("pyarrow", "pandas") if importlib.util.find_spec(m) is not None]
    res["installed_here"] = blocked
    if blocked:  # prove the path needs neither: the pipeline again without them
        arg = json.dumps({"vocab": cfg.vocab_size, "seq": seq, "cfg_kw": cfg_kw,
                          "device": str(dev)})
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               PHASE17_NO_ARROW_ARG, arg], capture_output=True, text=True,
                              timeout=300, cwd=HERE)
        if proc.returncode != 0:
            raise AssertionError(f"phase 17a without {blocked}: exit {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        sub = json.loads(proc.stdout.strip().splitlines()[-1])
        if sub["pyarrow"] or sub["pandas"]:
            raise AssertionError(f"phase 17a without {blocked}: they were imported: {sub}")
        if (sub["pred"] != pred.tolist() or sub["logit_sum"] != total.tolist()
                or sub["sorted_pred"] != pred[order].tolist()
                or sub["counts"] != {str(k): v for k, v in counts.items()}):
            raise AssertionError(f"phase 17a without {blocked}: results differ")
        res["no_arrow_subprocess_s"] = time.perf_counter() - t0
    elif any(sys.modules.get(m) is not None for m in ("pyarrow", "pandas")):
        raise AssertionError("phase 17a: pyarrow or pandas was imported")
    res["part_s"] = time.perf_counter() - t_part
    log(f"phase 17a: {json.dumps(res)}")
    return res, launches


def phase17b_loop(config):
    """17b's train loop (one worker asking for the GPU): make_train_state on
    prepare_mesh's one-rank mesh from 9b's seed, then one step a batch of
    the Dataset from train_loop_config, drawn by iter_torch_batches onto
    the mesh's device; a report a step. Writes each step's wait for its
    batch (the iterator's next() alone), its ms (host clock, the loss read
    back) and its report's ms to <trial_dir>/data_<pid>.json."""
    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import tpu_train as TT

    rec = {"pid": os.getpid(), "wait_ms": [], "step_ms": [], "report_ms": [], "devices": []}
    ctx = train.get_context()
    mesh = train.prepare_mesh(("dp", "tp"), device=config["device"])
    params, state, tx, shardings = TT.make_train_state(config["cfg"], mesh, seed=config["seed"])
    step, _ = TT.make_train_step(config["cfg"], mesh, tx, shardings)
    it = iter(config["dataset"].iter_torch_batches(batch_size=config["batch"],
                                                   device=mesh.device))
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        t1 = time.perf_counter()
        rec["wait_ms"].append(1e3 * (t1 - t0))
        rec["devices"].append(str(batch["tokens"].device))
        _, _, loss = step(params, state, {"tokens": batch["tokens"]})
        loss = float(loss)
        t2 = time.perf_counter()
        rec["step_ms"].append(1e3 * (t2 - t1))
        train.report({"loss": loss, "step": len(rec["step_ms"])})
        rec["report_ms"].append(1e3 * (time.perf_counter() - t2))
    with open(os.path.join(ctx.get_trial_dir(), f"data_{os.getpid()}.json"), "w") as f:
        json.dump(rec, f)


def phase17b_train(torch, PT, TT, dev, cfg=None, seq=2048, gpu="cuda"):
    """Data into the Train library, in a Cluster of its own (the default
    policy on the card) with one node offering {"GPU": 1}: tokens [64, seq
    + 1] through from_numpy(...).random_shuffle(seed=24).repartition(1)
    (one block: the shuffle's partitions hold random row counts, and
    batches never span blocks), materialized here and passed to
    JaxTrainer's one worker through train_loop_config; the worker takes a make_train_step
    step on each of its 8 batches (one epoch). Here the same Dataset's
    iter_batches gives the same shuffled batches, which 9b's step from
    9b's seed takes on the card: the 8 losses bit-equal. The worker's
    counters are read through WorkerGroup.execute when its group shuts
    down: each training kernel its count a step times 8. Returns
    (results, the worker's launches)."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import data, train
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.config import Config

    class CountingBackend(train.JaxBackend):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.groups = []

        def on_shutdown(self, worker_group):
            self.groups.append(worker_group.execute("run", _worker_counts))
            super().on_shutdown(worker_group)

    t_part = time.perf_counter()
    cfg = cfg or PT.TransformerConfig()
    tokens = np.random.default_rng(PHASE17_TRAIN_TOKEN_SEED).integers(
        0, cfg.vocab_size, (PHASE17_ROWS, seq + 1)).astype(np.int32)
    overrides = {"jax_policy_min_cells": 0}
    if gpu != "cuda":
        overrides["scheduler_device"] = gpu
    config = Config(overrides)
    _shm_room(1, config.object_store_memory_bytes, phase="17b")
    storage = tempfile.mkdtemp(prefix="phase17_")
    c = Cluster(config=config)
    pids = []
    try:
        c.add_node(num_cpus=PHASE13_NODE_CPUS, node_id=PHASE15_NODE, resources={"GPU": 1})
        c.wait_for_nodes(1, timeout=60)
        rt.init(address=c.address)
        # lazy: the shuffle's exchange runs in the train worker, from the
        # blocks this process put; this process then runs it again below
        ds = data.from_numpy(tokens, column="tokens").random_shuffle(
            seed=PHASE17_SHUFFLE_SEED).repartition(1)
        backend = CountingBackend()
        t0 = time.perf_counter()
        result = train.JaxTrainer(
            phase17b_loop, jax_backend=backend,
            train_loop_config={"cfg": cfg, "seed": TRAIN_SEED, "dataset": ds,
                               "batch": PHASE17_BATCH,
                               "device": None if gpu == "cuda" else gpu},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=gpu == "cuda"),
            run_config=RunConfig(name="phase17b", storage_path=storage)).fit()
        fit_s = time.perf_counter() - t0
        if result.error is not None:
            raise AssertionError(f"phase 17b: the run failed: {result.error!r}")
        recs = _records(result.path, "data_")
        pids += [r["pid"] for r in recs]
        # the same Dataset's batches, here: 9b's step from 9b's seed on them
        batches = [np.array(b["tokens"]) for b in ds.iter_batches(batch_size=PHASE17_BATCH)]
    finally:
        procs = _cluster_procs(c)
        try:
            rt.shutdown()
        finally:
            c.shutdown()
            killed = _reap(procs)
    deadline = time.time() + PHASE15_DEAD_AFTER_S
    while any(_pid_alive(p) for p in pids) and time.time() < deadline:
        time.sleep(0.2)
    alive = [p for p in pids if _pid_alive(p)]
    if alive or killed:
        raise AssertionError(f"phase 17b: train workers alive {PHASE15_DEAD_AFTER_S} s "
                             f"after shutdown: {alive}, killed {killed}")
    if len(recs) != 1:
        raise AssertionError(f"phase 17b: {len(recs)} worker records, one expected")
    rec = recs[0]
    rows = sorted(int(r) for b in batches for r in b[:, 0])
    if [b.shape for b in batches] != [(PHASE17_BATCH, seq + 1)] * (PHASE17_ROWS // PHASE17_BATCH) \
            or rows != sorted(int(r) for r in tokens[:, 0]):
        raise AssertionError(f"phase 17b: the shuffled batches {[b.shape for b in batches]} "
                             "are not the 64 rows in 8 batches of 8")
    params, state, tx, shardings = TT.make_train_state(cfg, seed=TRAIN_SEED, device=dev)
    step, _ = TT.make_train_step(cfg, None, tx, shardings)
    want = [float(step(params, state, {"tokens": b})[2]) for b in batches]
    got = [m["loss"] for m in result.metrics_history]
    if got != want:
        raise AssertionError(f"phase 17b: the worker's losses {got} differ from 9b's step on "
                             f"the same batches {want}")
    want_dev = str(dev) if gpu == "cuda" else "cpu"
    if set(rec["devices"]) != {want_dev}:
        raise AssertionError(f"phase 17b: iter_torch_batches gave tensors on {rec['devices']}")
    counts = backend.groups[0][0]
    launches = {k: counts["launches"][k] for k in TRAIN_KERNELS}
    if gpu == "cuda":
        want_l = {k: n * len(batches) for k, n in TRAIN_LAUNCHES_PER_STEP.items()}
        if launches != want_l:
            raise AssertionError(f"phase 17b: the worker's launches {launches}, predicted "
                                 f"{want_l}")
        if any(counts["tc"][k] != counts["launches"][k] for k in ("attention", "attention_bwd")):
            raise AssertionError(f"phase 17b: K8/K8' not all on the tensor cores: {counts}")
    res = {"steps": len(got), "losses": got, "losses_bit_equal_9b_step": True,
           "shuffle_seed": PHASE17_SHUFFLE_SEED, "fit_s": fit_s,
           "first_wait_ms": rec["wait_ms"][0], "wait_ms": rec["wait_ms"][1:],
           "step_ms": rec["step_ms"], "first_step_ms": rec["step_ms"][0],
           "report_ms": rec["report_ms"],
           "wait_share_after_first": sum(rec["wait_ms"][1:]) / (
               sum(rec["wait_ms"][1:]) + sum(rec["step_ms"][1:])),
           "batch_device": rec["devices"][0], "launches": launches,
           "part_s": time.perf_counter() - t_part}
    log(f"phase 17b: {json.dumps(res)}")
    return res, launches


def _touch(path):
    n = int(open(path).read()) if os.path.exists(path) else 0
    with open(path, "w") as f:
        f.write(str(n + 1))


def _wf_load(seed, rows, seq, vocab, marker):
    """17c's first step: a seeded token batch."""
    _touch(marker + ".load")
    return np.random.default_rng(seed).integers(0, vocab, (rows, seq)).astype(np.int32)


def _wf_forward(tokens, cfg_kw, device, marker):
    """17c's second step: the forward on the card, inside its task; the
    last position's logits. The workflow pickles its DAG into storage, this
    function by value where the script runs as __main__, so the model is
    looked up in this script's module when the step runs: a global named
    here would be pickled with it (the cache's lock cannot be)."""
    _touch(marker + ".forward")
    model, fwd = sys.modules[__name__]._phase17_model(cfg_kw, device)
    return fwd(model, tokens)[:, -1].float().cpu().numpy()


def _wf_summarize(last, marker):
    """17c's third step: per row the argmax and the float64 sum; raises
    while the flag file exists."""
    _touch(marker + ".summarize")
    if os.path.exists(marker + ".flag"):
        raise RuntimeError("injected failure in summarize (the flag file exists)")
    return last.argmax(-1).astype(np.int64), last.astype(np.float64).sum(-1)


def _pool_forward(tokens, cfg_kw, device):
    model, fwd = _phase17_model(cfg_kw, device)
    return _last_position(fwd(model, tokens))


def _queue_producer(q, batches):
    for b in batches:
        q.put(b, timeout=60)
    return len(batches)


def phase17cd_host(torch, MK, ctx, cfg_kw=None, seq=2048, gpu="cuda"):
    """(c) Workflow in a local runtime (the default config on the card):
    step(load) -> step(forward) -> step(summarize), the forward on the
    card inside its task; summarize raises while a flag file exists, so
    run raises; resume after the flag is gone reruns summarize only (load
    and forward ran once: their results come from storage, and the
    forward's launches do not move), and its result equals 6b's forward.
    (d) the host utilities: a Queue(maxsize=2) carries 4 token batches from
    a producer task to this process, which runs the forward; Pool(2).map
    runs the forward over the same batches in tasks; both equal 6b's
    forward. The model kernels' counters from 0 over each part. Returns
    (results, launches by part)."""
    import functools
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch.util.multiprocessing import Pool
    from ray_tpu_torch.util.queue import Queue

    cfg, fwd, model = ctx["cfg"], ctx["fwd"], ctx["model"]
    dev = model.device
    key = (json.dumps(cfg_kw, sort_keys=True), str(dev))
    with _PHASE17_MODELS_LOCK:  # the tasks' forward is 6b's model
        _PHASE17_MODELS.setdefault(key, (model, fwd))
    rng = np.random.default_rng(PHASE17_HOST_SEED)
    batches = [rng.integers(0, cfg.vocab_size, (PHASE17_BATCH, seq)).astype(np.int32)
               for _ in range(PHASE17_HOST_BATCHES)]
    direct = [_last_position(fwd(model, b)) for b in batches]
    root = tempfile.mkdtemp(prefix="phase17c_")
    marker = os.path.join(root, "steps")
    res, launches = {}, {}
    rt.init(num_cpus=8, _system_config={} if gpu == "cuda" else {"scheduler_device": gpu})
    try:
        # (c)
        t0 = time.perf_counter()
        open(marker + ".flag", "w").close()
        loaded = workflow.step(_wf_load)(PHASE17_HOST_SEED + 1, PHASE17_BATCH, seq,
                                         cfg.vocab_size, marker)
        dag = workflow.step(_wf_summarize, max_retries=0)(
            workflow.step(_wf_forward)(loaded, cfg_kw, str(dev), marker), marker)
        MK.reset_launch_counts()
        try:
            workflow.run(dag, "phase17c", storage_root=root)
        except Exception as e:  # noqa: BLE001 - the injected failure, checked below
            failure = repr(e)
        else:
            raise AssertionError("phase 17c: run did not raise the injected failure")
        if "injected failure in summarize" not in failure:
            raise AssertionError(f"phase 17c: run raised {failure}, not the injected failure")
        after_run = MK.launch_counts()
        status = workflow.list_all(root)
        os.remove(marker + ".flag")
        got = workflow.resume("phase17c", storage_root=root)
        after_resume = MK.launch_counts()
        runs = {s: int(open(f"{marker}.{s}").read()) for s in ("load", "forward", "summarize")}
        if runs != {"load": 1, "forward": 1, "summarize": 2}:
            raise AssertionError(f"phase 17c: steps ran {runs}; resume must rerun summarize only")
        if after_resume != after_run:
            raise AssertionError(f"phase 17c: the forward's launches moved on resume: "
                                 f"{after_run} -> {after_resume}")
        tokens = _wf_load(PHASE17_HOST_SEED + 1, PHASE17_BATCH, seq, cfg.vocab_size,
                          marker + ".check")
        want = _last_position(fwd(model, tokens))
        if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
            raise AssertionError("phase 17c: the workflow's result differs from the direct "
                                 "forward's")
        if status != [{"workflow_id": "phase17c", "status": "FAILED", "steps_done": 2}] \
                or workflow.list_all(root)[0]["status"] != "FINISHED":
            raise AssertionError(f"phase 17c: statuses {status}, {workflow.list_all(root)}")
        launches["17c"] = {k: after_resume[k] for k in PHASE17_FORWARD_KERNELS}
        res["17c"] = {"run_raised": True, "steps_run": runs, "equal_direct": True,
                      "status_after_run": status[0]["status"],
                      "launches_after_run": launches["17c"],
                      "launches_moved_on_resume": False,
                      "part_s": time.perf_counter() - t0}
        # (d)
        t0 = time.perf_counter()
        MK.reset_launch_counts()
        q = Queue(maxsize=2)
        producer = rt.remote(_queue_producer).remote(q, batches)
        from_queue = []
        for _ in batches:
            from_queue.append(_last_position(fwd(model, q.get(timeout=60))))
        if rt.get(producer, timeout=60) != len(batches) or not q.empty():
            raise AssertionError("phase 17d: the producer or the queue did not finish")
        q.shutdown()
        queue_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        with Pool(PHASE17_POOL) as pool:
            from_pool = pool.map(functools.partial(_pool_forward, cfg_kw=cfg_kw,
                                                   device=str(dev)), batches)
        pool_s = time.perf_counter() - t1
        after_d = MK.launch_counts()
        for what, outs in (("queue", from_queue), ("pool", from_pool)):
            for (p, s), (wp, ws) in zip(outs, direct):
                if not (np.array_equal(p, wp) and np.array_equal(s, ws)):
                    raise AssertionError(f"phase 17d: the {what}'s forward differs from the "
                                         "direct one")
        launches["17d"] = {k: after_d[k] for k in PHASE17_FORWARD_KERNELS}
        res["17d"] = {"batches": len(batches), "queue_equal_direct": True,
                      "pool_equal_direct": True, "queue_s": queue_s, "pool_s": pool_s,
                      "part_s": time.perf_counter() - t0}
    finally:
        rt.shutdown()
    if gpu == "cuda":
        for part, got_l in launches.items():
            if min(got_l.values()) == 0:
                raise AssertionError(f"phase {part}: a forward kernel never launched: {got_l}")
    log(f"phase 17c-d: {json.dumps(res)}, launches {launches}")
    return res, launches


def phase17(torch, PT, TT, MK, ctx, cfg_kw=None, seq=2048, gpu="cuda"):
    """Phase 17: 17a-17d in turn, each part's seconds logged, the phase
    within PHASE17_BUDGET_S. Returns (results, launches by part)."""
    t0 = time.perf_counter()
    res, by_part = {}, {}
    res["17a"], launches_a = phase17a_data(torch, MK, ctx, cfg_kw, seq, gpu)
    by_part["17a"] = {k: launches_a[k] for k in PHASE17_FORWARD_KERNELS}
    cfg = ctx["cfg"]
    res["17b"], by_part["17b"] = phase17b_train(torch, PT, TT, ctx["model"].device, cfg, seq,
                                                gpu)
    host, host_launches = phase17cd_host(torch, MK, ctx, cfg_kw, seq, gpu)
    res.update(host)
    by_part.update(host_launches)
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 17 seconds: " + ", ".join(f"{p} {res[p]['part_s']:.1f}"
                                          for p in ("17a", "17b", "17c", "17d"))
        + f"; phase {res['phase_s']:.1f}")
    if gpu == "cuda" and res["phase_s"] > PHASE17_BUDGET_S:
        raise AssertionError(f"phase 17 took {res['phase_s']:.1f} s, over its "
                             f"{PHASE17_BUDGET_S} s")
    return res, by_part


# ---------------------------------- phase 18: the autoscaler, state, dashboard

PHASE18_THRESHOLDS = (1.0, 0.0, 0.25, 0.75)  # 0.5 is phase 1's
PHASE18_MAX_WORKERS = 2000  # 18a's node type: the held-back rows' count
PHASE18_IDLE_S = 2.0
PHASE18_TICK_S = 0.3
PHASE18_TYPES = (("cpu2", {"CPU": 2}, 4), ("gpu", {"CPU": 1, "GPU": 1}, 1))
PHASE18_CPU_TASKS = 8
PHASE18_GPU_TASKS = 2
PHASE18_BURST = 1500  # tiny tasks on the scaled cluster: many short rounds
PHASE18_TERMINATE_S = PHASE18_IDLE_S + 15.0
PHASE18_BUDGET_S = 90.0
#: phase 18's kernels in the GCS's process (K1 every round, K2/K3 the view
#: refresh, K4 where a round's download is sparse: 0 at a few nodes)
PHASE18_HEAD_KERNELS = ("schedule_classes", "scatter_rows", "delta_clip", "compact_nonzero",
                        *FUSED_REFRESH)


def _stream_node_type(total, live):
    """18a's node type: the held-back rows' resources, as the column-wise
    median of the held-back rows that carry the accelerator (every class of
    the stream fits on it)."""
    held = total[live:]
    return np.median(held[held[:, 2] > 0], axis=0).astype(np.float32)


def _hypothetical(space, avail, total, alive, demand, node_types, current):
    """The matrix autoscaler.get_nodes_to_launch builds: the existing rows,
    then min(headroom, pending tasks) candidate rows of each type; with the
    demands, counts and each candidate's type."""
    demands = np.stack([space.vector(d["resources"]) for d in demand])
    counts = np.array([int(d["count"]) for d in demand], dtype=np.int32)
    cands, rows = [], []
    for nt in node_types:
        for _ in range(min(max(0, nt.max_workers - current.get(nt.name, 0)),
                           int(counts.sum()))):
            cands.append(nt.name)
            rows.append(space.vector(nt.resources))
    hyp = (np.vstack([avail, np.stack(rows)]), np.vstack([total, np.stack(rows)]),
           np.concatenate([alive, np.ones(len(cands), bool)]), demands, counts)
    return hyp, cands


def _launches_of(assigned, n_existing, cands):
    used = assigned.sum(axis=0)
    out = {}
    for j, name in enumerate(cands):
        if used[n_existing + j] > 0:
            out[name] = out.get(name, 0) + 1
    return out


def _k1_equal_np(KT, kernel_np, T, problem, thr, what):
    """K1 on the card and kernel_np on the host at spread threshold `thr`:
    0 differing cells of assigned and avail bit-equal, or this fails.
    Returns (K1's assigned on the host, kernel_np's host ms, K1's args)."""
    args = tuple(T(a) for a in problem)
    t0 = time.perf_counter()
    a_n, v_n = kernel_np.schedule_classes(problem[0].copy(), *problem[1:],
                                          spread_threshold=thr)
    np_ms = 1e3 * (time.perf_counter() - t0)
    a_k, v_k = KT.schedule_classes(*args, spread_threshold=thr)
    a_k = a_k.cpu().numpy()
    diff = int((a_k != a_n).sum())
    if diff or v_k.cpu().numpy().tobytes() != v_n.tobytes():
        raise AssertionError(f"phase 18a K1 {what} at spread_threshold {thr}: {diff} cells "
                             "of assigned differ from kernel_np's, or avail is not bit-equal")
    return a_k, np_ms, args


def phase18a_decision(torch, KT, kernel_np, dev):
    """The launch decision at config_5's scale: the stream fleet (10 000
    nodes, 256 classes) with its last 20 % held back, the first round's
    demand, one node type with the held-back rows' resources and
    max_workers 2 000. get_nodes_to_launch (kernel_np on the host, spread
    threshold 1.0) gives the launch counts; K1 on the card, on the same
    hypothetical matrix, gives assigned and avail bit-equal to kernel_np's
    at 1.0 and so the same launches, then at 0.0, 0.25 and 0.75; and K1 is
    held to kernel_np at those four thresholds on phase 1's problems (0.5
    is phase 1's own). kernel_np's host ms beside K1's CUDA-event ms."""
    from ray_tpu_torch.autoscaler.autoscaler import NodeTypeConfig, get_nodes_to_launch
    from ray_tpu_torch.sched.resources import ResourceSpace

    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    space = ResourceSpace()
    total5, _, demands5, counts5 = build_stream_problem(np.random.default_rng(5))
    live = int(len(total5) * 0.8)
    first = np.floor(counts5 / 10).astype(np.int32)
    demand = [{"resources": space.unvector(demands5[c]), "count": int(first[c])}
              for c in range(len(first)) if first[c] > 0]
    nt = NodeTypeConfig("stream", space.unvector(_stream_node_type(total5, live)),
                        max_workers=PHASE18_MAX_WORKERS)
    existing = (total5[:live].copy(), total5[:live], np.ones(live, bool))
    t0 = time.perf_counter()
    launch = get_nodes_to_launch(space, *existing, demand, [nt], {})
    decide_ms = 1e3 * (time.perf_counter() - t0)
    if not launch or sum(launch.values()) > PHASE18_MAX_WORKERS:
        raise AssertionError(f"phase 18a: launches {launch}")
    hyp, cands = _hypothetical(space, *existing, demand, [nt], {})
    res = {"nodes": len(hyp[0]), "classes": len(hyp[3]), "candidates": len(cands),
           "node_type": nt.resources, "launch": launch,
           "get_nodes_to_launch_host_ms": decide_ms, "by_threshold": {}}
    for thr in PHASE18_THRESHOLDS:
        a_k, np_ms, args = _k1_equal_np(KT, kernel_np, T, hyp, thr, "on the hypothetical rows")
        got = _launches_of(a_k, live, cands)
        if thr == 1.0 and got != launch:
            raise AssertionError(f"phase 18a: K1's launches {got} != get_nodes_to_launch's "
                                 f"{launch}")
        res["by_threshold"][str(thr)] = {
            "placed": int(a_k.sum()), "launch": got, "kernel_np_host_ms": np_ms,
            "k1_ms": time_ms(torch, lambda: KT.schedule_classes(*args, spread_threshold=thr))}
    t0 = time.perf_counter()
    problems = k1_problems() + k1_edge_problems()
    for name, problem in problems:
        for thr in PHASE18_THRESHOLDS:
            _k1_equal_np(KT, kernel_np, T, problem, thr, name)
    res["phase1_problems_checked"] = len(problems)
    res["phase1_problems_s"] = time.perf_counter() - t0
    log(f"phase 18a: {json.dumps(res)}")
    return res


def phase18_gpu_task(problem, device):
    """18b's GPU task, in a worker of the autoscaled GPU node: K1 on a
    problem from the object store, from the library phase 0 built (not
    rebuilt here, and not the plain version: the count of K1's launches in
    this process must move). Returns what the driver checks."""
    import torch

    from ray_tpu_torch.sched import _build, kernel_torch as KT

    dev = torch.device(device)
    before = KT.launch_counts()["schedule_classes"]
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    a, v = KT.schedule_classes(*(T(x) for x in problem))
    return {"assigned": a.cpu().numpy(), "avail": v.cpu().numpy(), "device": str(a.device),
            "launches": KT.launch_counts()["schedule_classes"] - before,
            "build_seconds": _build.LIBRARY.build_seconds,
            "library": _build.LIBRARY.library_path().name, "pid": os.getpid(),
            "node": os.environ.get("RAY_TPU_NODE_ID")}


def phase18_problem(seed):
    """18b's GPU tasks' problems: random_problem's kind at 512 nodes."""
    return random_problem(seed, N=512, C=16)


def phase18_cpu_task(i):
    time.sleep(0.5)
    return i * i


def phase18_tiny(i):
    return i + 1


class _PolicyLog(logging.Handler):
    """Counts the torch_cuda policy's discarded pipelined windows and the
    guard's records."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.discards, self.guard = 0, []

    def emit(self, record):
        msg = record.getMessage()
        if "topology changed mid-window" in msg:
            self.discards += 1
        if "violated scheduling invariant" in msg:
            self.guard.append(msg)


def _phase18_cluster(gpu):
    """18b's and 18c's cluster: the GCS here (torch_cuda on `gpu`, every
    round on the device) and a recording FakeNodeProvider; no node yet."""
    from ray_tpu_torch.autoscaler import FakeNodeProvider
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.config import Config

    overrides = {"jax_policy_min_cells": 0}
    if gpu != "cuda":
        overrides["scheduler_device"] = gpu
    config = Config(overrides)
    _shm_room(sum(m for _, _, m in PHASE18_TYPES), config.object_store_memory_bytes,
              phase="18")
    c = Cluster(config=config)
    policy = c.gcs.policy
    if policy.name != "torch_cuda" or policy.device.type != gpu:
        c.shutdown()
        raise AssertionError(f"phase 18: GCS policy {policy.name} on {policy.device}")

    class Provider(FakeNodeProvider):
        """Records each node's create and terminate times, the demand the
        GCS reported when it was asked for, and its worker processes (taken
        before the daemon stops them); counts creates still in flight (a
        daemon is listed only once it has registered)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.created, self.terminated, self.procs = {}, {}, []
            self.peak, self.why, self.inflight = {}, {}, 0

        def create_node(self, node_type, resources):
            with self._lock:
                self.inflight += 1
            t = time.perf_counter()
            st = c.gcs.rpc_autoscaler_state({}, None)
            why = {"pending_demand": st.get("pending_demand"),
                   "pending_pgs": len(st.get("pending_pgs") or ()),
                   "running": {n: v.get("running") for n, v in st["nodes"].items()
                               if v.get("alive")}}
            try:
                nid = super().create_node(node_type, resources)
            finally:
                with self._lock:
                    self.inflight -= 1
            self.created[nid] = (node_type, t)
            self.why[nid] = why
            up = sum(1 for n in self.non_terminated_nodes() if n.startswith(f"auto-{node_type}-"))
            self.peak[node_type] = max(self.peak.get(node_type, 0), up)
            return nid

        def terminate_node(self, node_id):
            d = self._daemons.get(node_id)
            if d is not None:
                self.procs += [w.proc for w in list(d.workers.values()) if w.proc is not None]
                self.terminated.setdefault(node_id, time.perf_counter())
            super().terminate_node(node_id)

    return c, Provider((c.host, c.gcs.port), config=c.config)


def _phase18_teardown(c, provider, scaler, what):
    """Stop the autoscaler, the driver, the provider's nodes and the
    cluster; every worker process they started must be gone within 20 s."""
    import ray_tpu_torch as rt

    procs = _cluster_procs(c) + provider.procs
    try:
        if scaler is not None:
            scaler.shutdown()
        rt.shutdown()
        provider.shutdown()
        procs += provider.procs
    finally:
        c.shutdown()
        killed = _reap(set(procs))
    if killed:
        raise AssertionError(f"phase {what}: workers alive 20 s after shutdown: {killed}")


def _phase18_wait_down(provider, since, what):
    deadline = since + PHASE18_TERMINATE_S
    while (provider.non_terminated_nodes() or provider.inflight) \
            and time.perf_counter() < deadline:
        time.sleep(0.1)
    left = provider.non_terminated_nodes() + ["(starting)"] * provider.inflight
    if left:
        raise AssertionError(f"phase {what}: nodes {left} not terminated "
                             f"{PHASE18_TERMINATE_S} s after the last task")
    if set(provider.created) != set(provider.terminated):
        raise AssertionError(f"phase {what}: launched {sorted(provider.created)}, "
                             f"terminated {sorted(provider.terminated)}; the demand at each "
                             f"launch {provider.why}")
    for name, _, most in PHASE18_TYPES:
        if provider.peak.get(name, 0) > most:
            raise AssertionError(f"phase {what}: {provider.peak[name]} {name} nodes up at "
                                 f"once, over max_workers {most}")
    return time.perf_counter() - since


def _drained_task_check(c, rt, what):
    """No task started on a node after the GCS marked it draining."""
    from ray_tpu_torch.util.events import list_events

    drained = {e["node_id"]: e["timestamp"] for e in list_events(limit=10_000)
               if e["label"] == "NODE_DRAINING" and e.get("node_id")}
    late = [t for t in rt.timeline() if t.get("node_id") in drained
            and (t.get("start") or 0) > drained[t["node_id"]]]
    if late:
        raise AssertionError(f"phase {what}: tasks started on draining nodes: {late[:3]}")
    return len(drained)


def phase18bd_autoscaler(kernel_np, gpu="cuda"):
    """18b: the v1 Autoscaler over a live Cluster (GCS here, torch_cuda on
    the card), a FakeNodeProvider and no node at the start; cpu2 {"CPU": 2}
    (max 4) and gpu {"CPU": 1, "GPU": 1} (max 1). 8 one-CPU tasks and 2
    num_gpus=1 tasks, each running K1 in its worker on a seeded problem
    made on the GPU node, its assigned equal to kernel_np's; then 1 500
    tiny tasks on the scaled cluster. 18d, with the scale-down paused: the dashboard
    head and the native client (rt_get of /api/nodes, /api/summary,
    /api/cluster_resources equal to the state API's; rt_call of a port
    function; rt_submit_job of an entrypoint that connects by the address
    and runs a task) and dump_timeline. Then every launched node is
    terminated within the idle timeout plus 15 s. Returns (results, the
    GPU tasks' K1 launches)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import Autoscaler, NodeTypeConfig

    res = {}
    t0_phase = time.perf_counter()
    c, provider = _phase18_cluster(gpu)
    scaler = None
    topo0 = c.gcs.state.topology_version
    try:
        scaler = Autoscaler((c.host, c.gcs.port), provider,
                            [NodeTypeConfig(n, r, max_workers=m) for n, r, m in PHASE18_TYPES],
                            idle_timeout_s=PHASE18_IDLE_S,
                            update_interval_s=PHASE18_TICK_S).start()
        rt.init(address=c.address)
        problems = [phase18_problem(180 + i) for i in range(PHASE18_GPU_TASKS)]
        want = [kernel_np.schedule_classes(p[0].copy(), *p[1:]) for p in problems]
        cpu_task = rt.remote(num_cpus=1)(phase18_cpu_task)
        gpu_task = rt.remote(num_gpus=1)(phase18_gpu_task)
        make = rt.remote(num_gpus=1)(phase18_problem)
        t0 = time.perf_counter()
        cpu_refs = [cpu_task.remote(i) for i in range(PHASE18_CPU_TASKS)]
        # each problem made by a task on the GPU node, so it reaches the GPU
        # task through that node's store (a put here, before any node is
        # up, stays local; an object on a cpu2 node is lost when the
        # autoscaler terminates that idle node before the GPU task's fresh
        # worker fetches it, PERF.md PR 25)
        gpu_refs = [gpu_task.remote(make.remote(180 + i), gpu)
                    for i in range(PHASE18_GPU_TASKS)]
        squares = rt.get(cpu_refs, timeout=120)
        gpu_out = rt.get(gpu_refs, timeout=120)
        res["load_s"] = time.perf_counter() - t0
        res["first_launch_s"] = min(t for _, t in provider.created.values()) - t0
        if squares != [i * i for i in range(PHASE18_CPU_TASKS)]:
            raise AssertionError(f"phase 18b: CPU task results {squares}")
        for i, (out, (a_n, v_n)) in enumerate(zip(gpu_out, want)):
            if not np.array_equal(out["assigned"], a_n) or not np.array_equal(out["avail"], v_n):
                raise AssertionError(f"phase 18b: GPU task {i}'s K1 differs from kernel_np's")
            if gpu == "cuda" and (out["launches"] != 1 or out["build_seconds"] != 0.0
                                  or out["device"] != "cuda:0"):
                raise AssertionError(f"phase 18b: GPU task {i} did not launch phase 0's K1 "
                                     f"on the card: {out}")
        res["gpu_tasks"] = [{k: o[k] for k in ("launches", "build_seconds", "library",
                                               "device", "node")} for o in gpu_out]
        if {o["node"] for o in gpu_out} != {n for n, (t, _) in provider.created.items()
                                            if t == "gpu"}:
            raise AssertionError(f"phase 18b: GPU tasks ran on {[o['node'] for o in gpu_out]}")
        t0 = time.perf_counter()
        tiny = rt.remote(num_cpus=1)(phase18_tiny)
        if rt.get([tiny.remote(i) for i in range(PHASE18_BURST)], timeout=120) != \
                list(range(1, PHASE18_BURST + 1)):
            raise AssertionError("phase 18b: the burst's results differ")
        res["burst_s"] = time.perf_counter() - t0

        # 18d: the dashboard and the native client while the nodes are up
        scaler.idle_timeout_s = 3600.0  # scale-down paused
        t18d = time.perf_counter()
        res["18d"] = phase18d_dashboard(c, PHASE18_CPU_TASKS + PHASE18_GPU_TASKS
                                        + PHASE18_BURST)
        res["18d"]["part_s"] = time.perf_counter() - t18d
        t_idle = time.perf_counter()
        scaler.idle_timeout_s = PHASE18_IDLE_S
        res["scale_down_s"] = _phase18_wait_down(provider, t_idle, "18b")
        res["nodes_launched"] = sorted(provider.created)
        res["launched_at_s"] = {n: round(t - t0_phase, 3) for n, (_, t) in provider.created.items()}
        res["terminated_at_s"] = {n: round(t - t0_phase, 3)
                                  for n, t in provider.terminated.items()}
        res["drained_nodes"] = _drained_task_check(c, rt, "18b")
        res["peak_by_type"] = provider.peak
    finally:
        _phase18_teardown(c, provider, scaler, "18b")
    res["topology_changes"] = c.gcs.state.topology_version - topo0
    return res, sum(o["launches"] for o in gpu_out)


def _take_json(lib, ptr):
    import ctypes

    if not ptr:
        raise AssertionError("phase 18d: the native client returned NULL")
    try:
        return json.loads(ctypes.string_at(ptr).decode())
    finally:
        lib.rt_free(ptr)


def _without_stats(nodes):
    return [{k: v for k, v in n.items() if k != "Stats"} for n in nodes]


def phase18d_dashboard(c, n_tasks):
    """18d over 18b's cluster (its n_tasks finished tasks); see
    phase18bd_autoscaler."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import _native
    from ray_tpu_torch.dashboard import DashboardHead
    from ray_tpu_torch.sched import kernel_torch
    from ray_tpu_torch.util import state

    lib = _native.load_library("native_client")
    head = DashboardHead(c.address)
    res = {}
    try:
        host, port = b"127.0.0.1", head.port
        for attempt in range(3):  # a heartbeat can land between the two reads
            nodes = _take_json(lib, lib.rt_get(host, port, b"/api/nodes"))
            summ = _take_json(lib, lib.rt_get(host, port, b"/api/summary"))
            cres = _take_json(lib, lib.rt_get(host, port, b"/api/cluster_resources"))
            same = (_without_stats(nodes) == _without_stats(
                        json.loads(json.dumps(state.list_nodes(), default=str)))
                    and summ == json.loads(json.dumps(state.summary(), default=str))
                    and cres == rt.cluster_resources())
            if same:
                break
            time.sleep(0.2)
        if not same:
            raise AssertionError(f"phase 18d: the native client's /api/nodes, /api/summary "
                                 f"or /api/cluster_resources differ from the state API's: "
                                 f"{nodes} {summ} {cres}")
        res["nodes_alive"] = summ["nodes_alive"]
        res["read_attempts"] = attempt + 1
        body = json.dumps({"func": "ray_tpu_torch.sched.kernel_torch:bucket_size",
                           "args": [10_000]}).encode()
        out = _take_json(lib, lib.rt_call(host, port, body))
        if out != {"result": kernel_torch.bucket_size(10_000)}:
            raise AssertionError(f"phase 18d: rt_call gave {out}")
        script = ("import os, ray_tpu_torch as rt; rt.init(address=os.environ['RAY_TPU_ADDRESS']);"
                  " f = rt.remote(num_cpus=1)(pow);"
                  " print('job-result', rt.get(f.remote(7, 2), timeout=60)); rt.shutdown()")
        env = {"PYTHONPATH": HERE + os.pathsep + os.environ.get("PYTHONPATH", "")}
        t0 = time.perf_counter()
        job = _take_json(lib, lib.rt_submit_job(host, port, json.dumps(
            {"entrypoint": f'{sys.executable} -c "{script}"', "env": env}).encode()))
        deadline = time.time() + 60
        while True:
            st = _take_json(lib, lib.rt_get(host, port, f"/api/jobs/{job['job_id']}".encode()))
            if st["status"] != "RUNNING" or time.time() > deadline:
                break
            time.sleep(0.2)
        logs = _take_json(lib, lib.rt_get(host, port,
                                          f"/api/jobs/{job['job_id']}/logs".encode()))
        if st["status"] != "SUCCEEDED" or "job-result 49" not in logs["logs"]:
            raise AssertionError(f"phase 18d: the job {st}, its log {logs['logs'][-2000:]}")
        res["job_s"] = time.perf_counter() - t0
        res["job_status"] = st["status"]
        with tempfile.TemporaryDirectory() as d:
            # every task event the GCS kept (its default listing is the last 1 000)
            path = state.dump_timeline(os.path.join(d, "timeline.json"),
                                       state.list_tasks(limit=10 * n_tasks))
            with open(path) as f:
                trace = json.load(f)
        mine = {"phase18_cpu_task": PHASE18_CPU_TASKS, "phase18_gpu_task": PHASE18_GPU_TASKS,
                "phase18_tiny": PHASE18_BURST}
        got = {name: sum(1 for e in trace if e["name"] == name and e["ph"] == "X"
                         and e["args"]["status"] == "FINISHED") for name in mine}
        if got != mine:
            raise AssertionError(f"phase 18d: the timeline's complete events {got}, "
                                 f"one a finished task {mine}")
        res["timeline_events"] = len(trace)
    finally:
        head.shutdown()
    return res


def phase18c_autoscaler_v2(gpu="cuda"):
    """18c: AutoscalerV2 in the same shape, with a pending STRICT_PACK group
    whose bundles sum to one cpu2 node: it brings that node up. Every
    instance's history walks legal transitions and ends TERMINATED; the
    group's debits go through the GCS's _flush_before_debit."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import NodeTypeConfig
    from ray_tpu_torch.autoscaler.instance_manager import (
        _TRANSITIONS, AutoscalerV2, InstanceStatus)
    from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group

    res = {}
    c, provider = _phase18_cluster(gpu)
    scaler = None
    flushes = {"calls": 0, "inflight": 0}
    inner = c.gcs._flush_before_debit

    def counted():
        flushes["calls"] += 1
        flushes["inflight"] += bool(getattr(c.gcs.policy, "pipelined", False)
                                    and c.gcs.policy.has_inflight())
        inner()

    c.gcs._flush_before_debit = counted
    topo0 = c.gcs.state.topology_version
    try:
        scaler = AutoscalerV2((c.host, c.gcs.port), provider,
                              [NodeTypeConfig(n, r, max_workers=m) for n, r, m in PHASE18_TYPES],
                              idle_timeout_s=PHASE18_IDLE_S,
                              update_interval_s=PHASE18_TICK_S).start()
        rt.init(address=c.address)
        t0 = time.perf_counter()
        pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK")
        if not pg.ready(timeout=60):
            raise AssertionError("phase 18c: the STRICT_PACK group was not placed")
        res["pg_ready_s"] = time.perf_counter() - t0
        up = provider.non_terminated_nodes()
        if len(up) != 1 or not up[0].startswith("auto-cpu2-"):
            raise AssertionError(f"phase 18c: the group brought up {up}, one cpu2 expected")
        cpu_task = rt.remote(num_cpus=1)(phase18_cpu_task)
        gpu_task = rt.remote(num_gpus=1, num_cpus=1)(phase18_tiny)
        t0 = time.perf_counter()
        refs = [cpu_task.remote(i) for i in range(PHASE18_CPU_TASKS)] + \
            [gpu_task.remote(i) for i in range(PHASE18_GPU_TASKS)]
        got = rt.get(refs, timeout=120)
        if got != [i * i for i in range(PHASE18_CPU_TASKS)] + \
                list(range(1, PHASE18_GPU_TASKS + 1)):
            raise AssertionError(f"phase 18c: task results {got}")
        res["load_s"] = time.perf_counter() - t0
        remove_placement_group(pg)
        t_down = time.perf_counter()
        res["scale_down_s"] = _phase18_wait_down(provider, t_down, "18c")
        # the record turns TERMINATED once the provider's terminate returned
        while any(i.status == InstanceStatus.TERMINATING for i in scaler.im.instances()) \
                and time.perf_counter() < t_down + PHASE18_TERMINATE_S:
            time.sleep(0.05)
        insts = scaler.im.instances()
        for inst in insts:
            walk = [h[2] for h in inst.history]
            if inst.status != InstanceStatus.TERMINATED or any(
                    to not in _TRANSITIONS[frm] for _, frm, to, _ in inst.history[1:]):
                raise AssertionError(f"phase 18c: instance {inst.instance_id} walked {walk}")
        res["instances"] = len(insts)
        res["walks"] = sorted({" > ".join(h[2] for h in i.history) for i in insts})
        res["drained_nodes"] = _drained_task_check(c, rt, "18c")
        res["peak_by_type"] = provider.peak
    finally:
        _phase18_teardown(c, provider, scaler, "18c")
    if flushes["calls"] == 0:
        raise AssertionError("phase 18c: the group's debits never went through "
                             "_flush_before_debit")
    res["flush_before_debit"] = flushes
    res["topology_changes"] = c.gcs.state.topology_version - topo0
    return res


def phase18e_launcher(gpu="cuda"):
    """18e: cluster_up from a YAML with a head and two workers (the head's
    GCS in a process of its own, on the card by default: its process maps
    the scheduler kernels' library once a round ran), one task's round
    trip, cluster_down; no process of the cluster is left. Runs only where
    PyYAML imports (launcher.py reads the YAML with it)."""
    try:
        import yaml  # noqa: F401
    except ImportError:
        log("phase 18e: PyYAML is not installed here; the launcher is held to the CPU "
            "tests only")
        return {"pyyaml": False}
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler.launcher import cluster_down, cluster_up, list_clusters
    from ray_tpu_torch.sched import _build

    res = {"pyyaml": True}
    name = f"phase18e-{os.getpid()}"
    with tempfile.TemporaryDirectory() as d:
        cfg = os.path.join(d, "cluster.yaml")
        with open(cfg, "w") as f:
            yaml.safe_dump({"cluster_name": name, "provider": {"type": "local"},
                            "head_node": {"num_cpus": 2},
                            "worker_nodes": {"count": 2, "num_cpus": 2}}, f)
        # the head's GCS reads its config from the environment: every round
        # on the device, as phase 13's jax_policy_min_cells 0
        env = {"RAY_TPU_jax_policy_min_cells": "0"}
        if gpu != "cuda":
            env["RAY_TPU_scheduler_device"] = gpu
        old = {k: os.environ.pop(k, None) for k in ("RAY_TPU_scheduler_device",
                                                      "RAY_TPU_jax_policy_min_cells")}
        os.environ.update(env)
        t0 = time.perf_counter()
        try:
            up = cluster_up(cfg)
        finally:
            for k, v in old.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        res["up_s"] = time.perf_counter() - t0
        children = []
        try:
            if not any(x["cluster_name"] == name for x in list_clusters()):
                raise AssertionError("phase 18e: list_clusters does not list the cluster")
            rt.init(address=up["address"])
            ping = rt.remote(num_cpus=1)(phase18_tiny)
            if rt.get(ping.remote(41), timeout=120) != 42:
                raise AssertionError("phase 18e: the task's round trip failed")
            res["cluster_cpus"] = rt.cluster_resources().get("CPU")
            rt.shutdown()
            with open(f"/proc/{up['pids'][0]}/maps") as f:
                maps = f.read()
            res["head_maps_sched_library"] = _build.LIBRARY.library_path().name in maps
            if gpu == "cuda" and not res["head_maps_sched_library"]:
                raise AssertionError("phase 18e: the head's GCS never loaded the scheduler "
                                     "kernels' library")
            children = [int(p) for p in os.listdir("/proc") if p.isdigit()
                        and _ppid(int(p)) in set(up["pids"])]
        finally:
            killed = cluster_down(cfg)
        deadline = time.time() + 20
        everything = list(up["pids"]) + children
        while any(_pid_alive(p) for p in everything) and time.time() < deadline:
            time.sleep(0.2)
        alive = [p for p in everything if _pid_alive(p)]
        if alive or sorted(killed) != sorted(up["pids"]):
            raise AssertionError(f"phase 18e: after cluster_down alive {alive}, "
                                 f"killed {killed} of {up['pids']}")
    res["processes"] = len(everything)
    res["part_s"] = time.perf_counter() - t0
    log(f"phase 18e: {json.dumps(res)}")
    return res


def _ppid(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[1])
    except (OSError, ValueError, IndexError):
        return -1


def phase18(torch, KT, kernel_np, dev, gpu="cuda"):
    """Phase 18: 18a, then 18b-18d and 18c with the scheduler kernels'
    counters from 0 in this process (the GCS's), then 18e; the phase
    within PHASE18_BUDGET_S. Returns (results, the GCS's launches, the GPU
    tasks' K1 launches)."""
    from ray_tpu_torch.sched import policy as policy_mod

    t_phase = time.perf_counter()
    res = {}
    t0 = time.perf_counter()
    res["18a"] = phase18a_decision(torch, KT, kernel_np, dev)
    res["18a"]["part_s"] = time.perf_counter() - t0
    plog = logging.getLogger(policy_mod.__name__)
    watch, level = _PolicyLog(), plog.level
    plog.addHandler(watch)
    plog.setLevel(logging.INFO)
    KT.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        res["18b"], gpu_k1 = phase18bd_autoscaler(kernel_np, gpu)
        res["18b"]["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["18c"] = phase18c_autoscaler_v2(gpu)
        res["18c"]["part_s"] = time.perf_counter() - t0
        head = {k: KT.launch_counts()[k] for k in PHASE18_HEAD_KERNELS}
    finally:
        plog.removeHandler(watch)
        plog.setLevel(level)
    res["discarded_windows"] = watch.discards
    if watch.guard:
        raise AssertionError(f"phase 18: the invariant guard fired: {watch.guard}")
    # phase 13's check: K1 every round, and the view refreshed on the card
    # (K2 where a few rows changed with no round in flight, K3 where a
    # delta met a round still in flight: 2 and 4 times in PR 25's runs)
    if gpu == "cuda" and (head["schedule_classes"] == 0
                          or head["scatter_rows"] + head["delta_clip"] == 0):
        raise AssertionError(f"phase 18: the GCS's rounds launched {head}")
    require_fused(refresh_forms({}, head), "phase 18 (the GCS's scan rounds)")
    t0 = time.perf_counter()
    res["18e"] = phase18e_launcher(gpu)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18: {json.dumps(res, default=str)}")
    if gpu == "cuda" and res["phase_s"] > PHASE18_BUDGET_S:
        raise AssertionError(f"phase 18 took {res['phase_s']:.1f} s, over its "
                             f"{PHASE18_BUDGET_S} s")
    return res, head, gpu_k1


# ------------------------------------------------------- phase 19: analysis
#
# The analysis plane over the port: the GCS model checker with its rounds on
# the card, the channel memory model and the round-trip gates, the runtime
# sanitizers around a cluster whose GCS rounds run on the card, and the
# linter's CLI over the whole package.

# the CLI's defaults (`python -m ray_tpu_torch.analysis --explore all`)
PHASE19_EXPLORE = dict(max_schedules=500, samples=200, max_depth=30, seed=0)
PHASE19_SEEDED = ("node-reconnect-instance", "register-node-double-book")
PHASE19_TASKS = 300
PHASE19_ACTOR_CALLS = 20
PHASE19_DAG_EXECUTES = 8


def _explore_view(res):
    """What must not depend on where the rounds ran."""
    return {
        "schedules_run": res.schedules_run, "dfs_schedules": res.dfs_schedules,
        "sampled_schedules": res.sampled_schedules,
        "branches_pruned": res.branches_pruned, "coverage": sorted(res.coverage),
        "found": res.found,
        "violation_kinds": sorted(res.violating.violation_kinds) if res.found else [],
        "shrunk": res.shrunk,
    }


def phase19a_explore(KT, policy_mod, gpu="cuda", explore_kw=None):
    """19a: every scenario of the GCS model checker at the CLI's defaults
    with the explored GCS's rounds on `gpu` (one synchronous K1 launch a
    `sched` step), then again with K1's plain version on the CPU in this
    process: no violation, and equal counts and coverage scenario by
    scenario. K1 launches at least once a round that has classes and
    nodes. Then the seeded double-book: found on the card, shrunk to the
    CPU run's schedule."""
    from ray_tpu_torch.analysis import explore as ex

    kw = dict(explore_kw or PHASE19_EXPLORE)
    rounds = [0]
    real = policy_mod.HybridPolicy.schedule

    def counted(self, state, demands, counts):
        if demands.shape[0] and len(state.node_ids):
            rounds[0] += 1
        return real(self, state, demands, counts)

    res = {"budget": kw, "scenarios": {}}
    policy_mod.HybridPolicy.schedule = counted
    try:
        for name in sorted(ex.SCENARIOS):
            KT.reset_launch_counts()
            rounds[0] = 0
            t0 = time.perf_counter()
            card = ex.explore(ex.SCENARIOS[name], device=gpu, **kw)
            card_s = time.perf_counter() - t0
            launches = KT.launch_counts()
            card_rounds = rounds[0]
            t0 = time.perf_counter()
            cpu = ex.explore(ex.SCENARIOS[name], device="cpu", **kw)
            cpu_s = time.perf_counter() - t0
            if card.found or cpu.found:
                raise AssertionError(f"phase 19a {name}: a violation "
                                     f"({card.summary()} / {cpu.summary()})")
            if _explore_view(card) != _explore_view(cpu):
                raise AssertionError(f"phase 19a {name}: the card's exploration differs "
                                     f"from the CPU's: {card.summary()} / {cpu.summary()}")
            if gpu == "cuda" and launches["schedule_classes"] < card_rounds:
                raise AssertionError(f"phase 19a {name}: K1 launched "
                                     f"{launches['schedule_classes']} times in "
                                     f"{card_rounds} rounds with work")
            res["scenarios"][name] = {
                "schedules": card.schedules_run, "dfs": card.dfs_schedules,
                "sampled": card.sampled_schedules, "coverage": len(card.coverage),
                "rounds_with_work": card_rounds, "launches": launches,
                "card_s": card_s, "cpu_s": cpu_s,
            }
            log(f"phase 19a {name}: {card.schedules_run} schedules ({card.dfs_schedules} "
                f"dfs + {card.sampled_schedules} sampled), {len(card.coverage)} coverage "
                f"pairs, {card_rounds} rounds with work, launches {launches}; "
                f"{card_s:.2f} s on {gpu}, {cpu_s:.2f} s on the CPU")
        scenario, bug = PHASE19_SEEDED
        KT.reset_launch_counts()
        t0 = time.perf_counter()
        card = ex.explore(ex.SCENARIOS[scenario], device=gpu, seeded_bugs=[bug], **kw)
        card_s = time.perf_counter() - t0
        launches = KT.launch_counts()
        cpu = ex.explore(ex.SCENARIOS[scenario], device="cpu", seeded_bugs=[bug], **kw)
        if not card.found or card.shrunk is None:
            raise AssertionError(f"phase 19a: {bug} not found on {gpu}: {card.summary()}")
        if _explore_view(card) != _explore_view(cpu):
            raise AssertionError(f"phase 19a: {bug}'s exploration on {gpu} differs from "
                                 f"the CPU's: {card.summary()} / {cpu.summary()}")
        res["seeded"] = {"bug": bug, "scenario": scenario, "schedules": card.schedules_run,
                         "kinds": sorted(card.violating.violation_kinds),
                         "shrunk_steps": len(card.shrunk), "launches": launches,
                         "card_s": card_s}
    finally:
        policy_mod.HybridPolicy.schedule = real
    res["launches"] = {k: sum(s["launches"][k] for s in res["scenarios"].values())
                       + res["seeded"]["launches"][k] for k in res["seeded"]["launches"]}
    if gpu == "cuda" and res["launches"]["schedule_classes"] == 0:
        raise AssertionError("phase 19a: K1 never launched")
    return res


def phase19b_models():
    """19b: every channel scenario of the memory model clean, each seeded
    channel bug found; memmodel's AST round trip over the port's
    dag/channel.py, and the protocol tracer's METHOD_TABLE within the
    protocol extracted from the port's tree."""
    from ray_tpu_torch.analysis import invariants, memmodel as mm, protocol

    res = {"scenarios": {}}
    for name in sorted(mm.CHANNEL_SCENARIOS):
        r = mm.explore_channel(mm.CHANNEL_SCENARIOS[name])
        if r.found:
            raise AssertionError(f"phase 19b: memmodel {name}: {r.summary()}")
        res["scenarios"][name] = {"schedules": r.schedules_run, "ops": r.ops_covered}
    res["seeded"] = {}
    for bug, name in mm.SEEDED_BUG_SCENARIOS:
        r = mm.explore_channel(mm.CHANNEL_SCENARIOS[name], max_schedules=2000, samples=0,
                               seeded_bugs=[bug])
        if not r.found or r.shrunk is None:
            raise AssertionError(f"phase 19b: memmodel missed {bug}: {r.summary()}")
        res["seeded"][bug] = {"schedules": r.schedules_run, "shrunk_ops": len(r.shrunk)}
    drift = mm.verify_op_sequences()
    if drift:
        raise AssertionError(f"phase 19b: dag/channel.py's op sequences drifted: {drift}")
    idx = protocol.extract_protocol([os.path.join(HERE, "ray_tpu_torch")], root=HERE)
    missing = sorted(set(invariants.METHOD_TABLE) - idx.handler_methods())
    if missing:
        raise AssertionError(f"phase 19b: METHOD_TABLE methods without handlers: {missing}")
    res["handlers"] = len(idx.handlers)
    return res


def phase19_square(x):
    return x * x


class Phase19Counter:
    def __init__(self):
        self.n = 0

    def add(self, k):
        self.n += k
        return self.n


class Phase19Stage:
    def __init__(self, k):
        self.k = k

    def apply(self, x):
        return [v * self.k + 1 for v in x]


def phase19c_sanitized_cluster(KT, gpu="cuda"):
    """19c: the protocol tracer, the race, wait-for and lock-order
    sanitizers installed in this process before a two-node Cluster whose
    GCS runs its rounds on `gpu`, pipelined (the default config, rounds of
    every size on the device); a few hundred tasks, an actor and a
    compiled graph over two stages; zero races, wait cycles, lock-order
    cycles and invariant violations, with K1 launched here. Then every
    race and wait probe, clean and seeded."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.analysis import invariants, racer, sanitizer, waitgraph
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.dag import InputNode, channel as chan_mod

    res = {}
    fd, trace = tempfile.mkstemp(prefix="phase19_trace_", suffix=".jsonl")
    os.close(fd)
    overrides = {"jax_policy_min_cells": 0}
    if gpu != "cuda":
        overrides["scheduler_device"] = gpu
    invariants.install(trace)
    race = racer.RaceSanitizer().install()
    wait = waitgraph.WaitSanitizer(stall_warn_s=30.0).install()
    locks = sanitizer.LockOrderSanitizer().install()
    try:
        if race.unresolved:
            raise AssertionError(f"phase 19c: unresolved watch entries {race.unresolved}")
        if chan_mod.PARKWATCH is not wait:
            raise AssertionError("phase 19c: the wait sanitizer is not the channels' PARKWATCH")
        KT.reset_launch_counts()
        t0 = time.perf_counter()
        c = Cluster(config=Config(overrides))
        procs = []
        try:
            pol = c.gcs.policy
            if pol.name != "torch_cuda" or pol.device.type != gpu or not pol.pipelined:
                raise AssertionError(f"phase 19c: GCS policy {pol.name} on {pol.device}, "
                                     f"pipelined {pol.pipelined}")
            for node in ("node-a", "node-b"):
                c.add_node(num_cpus=4, node_id=node)
            c.wait_for_nodes(2, timeout=60)
            rt.init(address=c.address)
            res["boot_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            square = rt.remote(phase19_square)
            got = rt.get([square.remote(i) for i in range(PHASE19_TASKS)], timeout=300)
            if got != [i * i for i in range(PHASE19_TASKS)]:
                raise AssertionError("phase 19c: task results differ")
            counter = rt.remote(Phase19Counter).remote()
            total = rt.get([counter.add.remote(k) for k in range(PHASE19_ACTOR_CALLS)],
                           timeout=120)[-1]
            if total != sum(range(PHASE19_ACTOR_CALLS)):
                raise AssertionError(f"phase 19c: the actor counted {total}")
            first = rt.remote(Phase19Stage).remote(2)
            second = rt.remote(Phase19Stage).remote(3)
            with InputNode() as inp:
                dag = second.apply.bind(first.apply.bind(inp))
            compiled = dag.compile()
            try:
                for i in range(PHASE19_DAG_EXECUTES):
                    out = compiled.execute([i, i + 1], timeout=120)
                    if out != [(v * 2 + 1) * 3 + 1 for v in (i, i + 1)]:
                        raise AssertionError(f"phase 19c: the compiled graph gave {out}")
            finally:
                compiled.teardown()
            res["workload_s"] = time.perf_counter() - t0
            for d in c.daemons:  # under the daemon's lock: the racer watches
                with d._lock:
                    procs += [w.proc for w in d.workers.values() if w.proc is not None]
        finally:
            try:
                rt.shutdown()
            finally:
                c.shutdown()
                killed = _reap(set(procs))
        res["launches"] = KT.launch_counts()
        if killed:
            raise AssertionError(f"phase 19c: workers alive 20 s after shutdown: {killed}")
    finally:
        locks.uninstall()
        wait.uninstall()
        race.uninstall()
        invariants.uninstall()
    violations = invariants.check_trace(trace)
    os.unlink(trace)
    res.update(races=len(race.races), watched_fields=race.report()["watched_fields"],
               wait_cycles=len(wait.deadlocks), stalls=len(wait.stalls),
               lock_order_cycles=len(locks.cycles()), invariant_violations=len(violations))
    if race.races:
        raise AssertionError(f"phase 19c: races\n{race.format_races()}")
    if wait.deadlocks:
        raise AssertionError(f"phase 19c: wait cycles {wait.deadlocks}")
    if locks.cycles():
        raise AssertionError(f"phase 19c: lock-order cycles {locks.cycles()}")
    if violations:
        raise AssertionError(f"phase 19c: invariant violations "
                             f"{[v.format() for v in violations][:5]}")
    if gpu == "cuda" and res["launches"]["schedule_classes"] == 0:
        raise AssertionError(f"phase 19c: the GCS's rounds launched {res['launches']}")
    # the probes: each clean run reports nothing, each seeded bug is caught
    res["probes"] = {}
    wl = racer.extract_watchlist()
    for name in sorted(racer.RACE_PROBES):
        r = racer.run_probe(name, rounds=3, watchlist=wl)
        if r.detected or r.unresolved:
            raise AssertionError(f"phase 19c: race probe {name} clean run: {r.summary()}")
    for bug, _mod, name in racer.SEEDED_RACES:
        r = racer.run_probe(name, seeded_bugs=[bug], rounds=3, watchlist=wl)
        if not r.detected:
            raise AssertionError(f"phase 19c: race probe {name} missed {bug}")
        res["probes"][bug] = r.rounds
    for name in sorted(waitgraph.WAIT_PROBES):
        r = waitgraph.run_probe(name, rounds=2)
        if r.detected:
            raise AssertionError(f"phase 19c: wait probe {name} clean run: {r.summary()}")
    for bug, _mod, name in waitgraph.SEEDED_WAITS:
        r = waitgraph.run_probe(name, seeded_bugs=(bug,), rounds=3)
        if not r.detected:
            raise AssertionError(f"phase 19c: wait probe {name} missed {bug}")
        res["probes"][bug] = r.rounds
    return res


def phase19d_cli():
    """19d: `python -m ray_tpu_torch.analysis ray_tpu_torch --format json`
    against an empty baseline: no new finding, no error, the whole tree."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        baseline = os.path.join(tmp, "baseline.json")
        with open(baseline, "w") as f:
            json.dump({"findings": {}}, f)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.analysis", "ray_tpu_torch",
             "--format", "json", "--baseline", baseline],
            cwd=HERE, env={**os.environ, "PYTHONPATH": HERE},
            capture_output=True, text=True, timeout=300,
        )
        secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 19d: the linter exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    data = json.loads(proc.stdout)
    if data["new"] or data["errors"] or data["files_scanned"] <= 100:
        raise AssertionError(f"phase 19d: {len(data['new'])} new findings, errors "
                             f"{data['errors']}, {data['files_scanned']} files")
    return {"files_scanned": data["files_scanned"], "suppressed": data["suppressed"],
            "checks": len(data["checks"]), "s": secs}


def phase19(KT, policy_mod, gpu="cuda", explore_kw=None):
    """Phase 19: 19a-19d, each part's seconds; returns the results and the
    scheduler kernels' launches of 19a (the explorer's rounds) and 19c (the
    sanitized cluster's GCS)."""
    t_phase = time.perf_counter()
    res = {}
    for part, fn in (("19a", lambda: phase19a_explore(KT, policy_mod, gpu, explore_kw)),
                     ("19b", phase19b_models),
                     ("19c", lambda: phase19c_sanitized_cluster(KT, gpu)),
                     ("19d", phase19d_cli)):
        t0 = time.perf_counter()
        res[part] = fn()
        res[part]["part_s"] = time.perf_counter() - t0
        log(f"phase {part}: {res[part]['part_s']:.1f} s")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 19: {json.dumps(res, default=str)}")
    for part in ("19a", "19c"):
        require_fused(refresh_forms({}, res[part]["launches"]), f"phase {part} (scan rounds)")
    return res, {"19a": res["19a"]["launches"], "19c": res["19c"]["launches"]}


# ------------------------------------------------------------------ phase 20
# The CLI and the scripts: a head started by `python -m ray_tpu_torch`
# scheduling on the card, the three storms with their embedded GCS on the
# card, the analysis gate with the RPC budget measured on a cluster whose
# GCS runs on the card, and the soaks. Every part runs with
# RAY_TPU_jax_policy_min_cells=0, so the small clusters' rounds reach the
# card and not the NumPy twin.

# measured at 224.1-283.8 s with 20c's and 20d's processes in groups
# (PERF.md)
PHASE20_BUDGET_S = 300.0
# every round on the card, synchronous: the phase's clusters have 2-10
# CPUs, whose rounds the default threshold would give to the synchronous
# NumPy twin. Pipelined (the default depth 8), a placement waits for the 8
# rounds behind it: the overload storm's cluster then ran at less than half
# its 75 tasks/s, and the workflow soak's driver took 8 attempts
# (PERF.md)
PHASE20_ENV = {"RAY_TPU_jax_policy_min_cells": "0", "RAY_TPU_jax_policy_pipeline_depth": "0"}
# storms whose timing bars are printed, not gated: the overload storm's
# --smoke goodput bars (ON >= 2x OFF, ON >= 0.5 x peak) are RED on the H100's
# host (ON 11.7 against OFF 10.0 rps, peak 70.0; PERF.md), a bar the port
# does not meet yet (ROADMAP queue 3); its exactness gates (no silent drop,
# a clean strict-terminal invariant check) are gated
PHASE20_TIMING_REPORTED = ("overload_storm",)
# each storm's main() at --smoke: run_storm's settings and the gate key
PHASE20_STORMS = (
    ("serve_storm", dict(duration_s=6.0, clients=48, replicas=3, chaos=True, seed=7,
                         kill_period_s=2.0, p99_bound_s=10.0), "slo_pass"),
    ("overload_storm", dict(seed=7, duration_s=6.0, peak_duration_s=3.0, mult_lo=3.0,
                            mult_hi=6.0, slo_s=1.2, kill_period_s=3.0, ratio_bar=2.0,
                            frac_bar=0.5), "storm_pass"),
    ("gray_storm", dict(seed=7, n_waves=14, warmup_waves=5, slow_factor=25.0,
                        p99_bar=3.0, goodput_bar=2.0), "storm_pass"),
)
# the soaks at the shortest durations their argv takes
PHASE20_SOAKS = (
    ("chaos_soak", ["--seed", "7", "--duration", "20"]),
    ("gcs_soak", ["15"]),
    ("data_soak", ["8"]),
    ("serve_soak", ["8"]),
    ("workflow_soak", []),
)
# 20c's and 20d's processes, a group's at once (each is mostly waits and
# sleeps; one after the other they took 276 s, PERF.md). The chaos soak
# runs beside four loaded processes, where it found an actor's calls run
# out of order; the GCS soak alone: its first restart comes at its loop's
# 526th task (its seed), which it reaches in 15 s only alone
PHASE20_GROUPS = (("chaos_soak", "lint_gate", "data_soak", "serve_soak", "workflow_soak"),
                  ("gcs_soak",))
PHASE20_SCHED_KERNELS = ("schedule_classes", "scatter_rows", "delta_clip", *FUSED_REFRESH)


@contextlib.contextmanager
def _environ(values):
    """This process's environment with `values` set, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _phase20_env(tmp):
    """A child's environment: this process's, which phase20 has set (its
    PHASE20_ENV and device), with the checkout and a TMPDIR of its own."""
    return {**os.environ, "PYTHONPATH": HERE, "TMPDIR": tmp}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gpu_apps():
    """nvidia-smi's compute apps, one pid each. In a container nvidia-smi
    may see another pid namespace and list every app as pid 1, so phase 20a
    counts the apps a process adds rather than finding its pid."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return sorted(int(x) for x in out.stdout.split() if x.strip().isdigit())


def _maps_cuda(pid):
    """Whether process `pid` has the CUDA driver library mapped."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "libcuda.so" in f.read()
    except OSError:
        return False


def _sched_round_count(prom):
    import re

    m = re.search(r"^ray_tpu_gcs_sched_round_s_count(?:\{[^}]*\})? (\S+)$", prom, re.M)
    return float(m.group(1)) if m else 0.0


def phase20a_cli(gpu="cuda"):
    """20a: `python -m ray_tpu_torch start --head` with the GPU resource,
    a worker node by `start --address`, then status, list nodes, summary,
    microbenchmark --quick, metrics, metrics --top, metrics --prom,
    stacks, a dashboard with a job's submit, status and logs, and stop,
    each step's exit code and key output checked. The head holds a CUDA
    context (it maps libcuda, and nvidia-smi lists one compute app more
    while it runs than before it started and after it stopped; nvidia-smi
    lists its pid where it shares the script's pid namespace) and its
    GCS's rounds count more than zero after the microbenchmark. A head
    that does not come up is run again in the foreground for its own
    error."""
    import tempfile

    res = {}
    tmp = tempfile.mkdtemp(prefix="phase20a-")
    env = _phase20_env(tmp)
    session = os.path.join(tmp, "ray_tpu_torch")

    def run(*args, timeout=120):
        return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args], cwd=tmp,
                              env=env, capture_output=True, text=True, timeout=timeout)

    def check(proc, what, *needles):
        text = proc.stdout + proc.stderr
        if proc.returncode != 0 or any(n not in proc.stdout for n in needles):
            raise AssertionError(f"phase 20a: {what} exited {proc.returncode}: {text[-3000:]}")
        return proc.stdout

    if gpu == "cuda":
        res["gpu_apps_before"] = _gpu_apps()
    t0 = time.perf_counter()
    head = run("start", "--head", "--num-cpus", "4", "--resources", '{"GPU": 1}')
    res["head_up_s"] = time.perf_counter() - t0
    if "head started" not in head.stdout:
        fg = None
        try:
            fg = run("start", "--head", "--num-cpus", "4", "--resources", '{"GPU": 1}',
                     "--block", timeout=60)
        except subprocess.TimeoutExpired as e:
            fg = e
        raise AssertionError(f"phase 20a: the head did not come up ({head.stderr.strip()}); "
                             f"in the foreground: {getattr(fg, 'stderr', fg)!s}"[-4000:])
    addr = head.stdout.split("at ")[1].split(" ")[0]
    pids = []
    dash = None
    try:
        with open(os.path.join(session, "pids")) as f:
            pids = [int(x) for x in f.read().split()]
        head_pid = pids[0]
        check(run("start", "--address", addr, "--num-cpus", "4"), "start --address",
              "node started")
        with open(os.path.join(session, "pids")) as f:
            pids = [int(x) for x in f.read().split()]
        deadline = time.time() + 60
        while True:
            st = check(run("status", "--address", addr), "status", "cluster summary")
            if "nodes_alive         2" in st or time.time() > deadline:
                break
            time.sleep(0.5)
        if "nodes_alive         2" not in st or "GPU" not in st:
            raise AssertionError(f"phase 20a: status {st}")
        nodes = json.loads(check(run("list", "nodes", "--address", addr), "list nodes"))
        if len(nodes) != 2 or not any(n["Resources"].get("GPU") == 1.0 for n in nodes):
            raise AssertionError(f"phase 20a: list nodes {nodes}")
        rounds_before = _sched_round_count(
            check(run("metrics", "--prom", "--address", addr), "metrics --prom"))
        mb = check(run("microbenchmark", "--address", addr, "--quick"), "microbenchmark",
                   "tasks_per_second")
        rates = {}
        for line in mb.splitlines()[1:]:
            k, _, v = line.rpartition(" ")
            rates[k.strip()] = float(v)
        if set(rates) != {"tasks_per_second", "actor_calls_per_second", "put_get_gbps_shm",
                          "arg_view_gbps"}:
            raise AssertionError(f"phase 20a: microbenchmark gave {rates}")
        res["microbenchmark"] = rates
        summ = json.loads(check(run("summary", "--address", addr), "summary"))
        if summ.get("noop", {}).get("FINISHED", 0) < 200:
            raise AssertionError(f"phase 20a: summary {summ}")
        check(run("metrics", "--address", addr), "metrics", "ray_tpu_gcs_rpc_handler_s")
        check(run("metrics", "--top", "--address", addr), "metrics --top", "surface",
              "submit_task")
        prom = check(run("metrics", "--prom", "--address", addr), "metrics --prom")
        res["head_rounds"] = _sched_round_count(prom)
        res["head_rounds_microbenchmark"] = res["head_rounds"] - rounds_before
        if res["head_rounds_microbenchmark"] <= 0:
            raise AssertionError(f"phase 20a: the head's GCS counted {res['head_rounds']} "
                                 f"rounds, {rounds_before} before the microbenchmark")
        res["head_pid"] = head_pid
        if gpu == "cuda":
            res["gpu_apps_with_head"] = _gpu_apps()
            res["head_maps_libcuda"] = _maps_cuda(head_pid)
            listed = (head_pid in res["gpu_apps_with_head"]
                      or len(res["gpu_apps_with_head"]) == len(res["gpu_apps_before"]) + 1)
            if not (listed and res["head_maps_libcuda"]):
                raise AssertionError(f"phase 20a: the head (pid {head_pid}) holds no CUDA "
                                     f"context: nvidia-smi's compute apps "
                                     f"{res['gpu_apps_before']} before it, "
                                     f"{res['gpu_apps_with_head']} with it; libcuda mapped: "
                                     f"{res['head_maps_libcuda']}")
        stacks = check(run("stacks"), "stacks", "== pid")
        res["stacks_processes"] = stacks.count("== pid")
        port = _free_port()
        dash = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "dashboard", "--address", addr,
             "--port", str(port)], cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        line = dash.stdout.readline()
        if "dashboard serving at" not in line:
            raise AssertionError(f"phase 20a: dashboard said {line!r}")
        board = f"127.0.0.1:{port}"
        check(run("job", "submit", "--dashboard", board, "--submission-id", "phase20",
                  "--", "echo", "phase20-job-output"), "job submit", '"phase20"')
        deadline = time.time() + 60
        while True:
            st = check(run("job", "status", "--dashboard", board, "phase20"), "job status")
            if '"SUCCEEDED"' in st or time.time() > deadline:
                break
            time.sleep(0.5)
        if '"SUCCEEDED"' not in st:
            raise AssertionError(f"phase 20a: job status {st}")
        check(run("job", "logs", "--dashboard", board, "phase20"), "job logs",
              "phase20-job-output")
    finally:
        if dash is not None:
            dash.send_signal(2)  # SIGINT: the dashboard shuts its head down
            try:
                dash.wait(timeout=20)
            except subprocess.TimeoutExpired:
                dash.kill()
                dash.wait(timeout=10)
        stop = run("stop")
        deadline = time.time() + 20
        while time.time() < deadline and any(os.path.exists(f"/proc/{p}") and
                                             not _zombie(p) for p in pids):
            time.sleep(0.2)
        left = [p for p in pids if os.path.exists(f"/proc/{p}") and not _zombie(p)]
        for p in left:
            os.kill(p, 9)
    if f"stopped {len(pids)} process(es)" not in stop.stdout or left:
        raise AssertionError(f"phase 20a: stop said {stop.stdout!r}, alive after 20 s {left}")
    if gpu == "cuda":  # a context is freed a moment after its process ends
        deadline = time.time() + 30
        while True:
            res["gpu_apps_after_stop"] = _gpu_apps()
            if (len(res["gpu_apps_after_stop"]) == len(res["gpu_apps_before"])
                    or time.time() > deadline):
                break
            time.sleep(0.5)
        if len(res["gpu_apps_after_stop"]) != len(res["gpu_apps_before"]):
            raise AssertionError(f"phase 20a: nvidia-smi's compute apps "
                                 f"{res['gpu_apps_after_stop']} 30 s after stop, "
                                 f"{res['gpu_apps_before']} before the head; the session's "
                                 f"processes {[(p, _zombie(p)) for p in pids]} (pid, ended)")
    if os.path.exists(os.path.join(session, "pids")):
        raise AssertionError("phase 20a: the session's pid file outlived stop")
    return res


def _zombie(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(") ", 1)[1][:1] == "Z"
    except OSError:
        return True


def phase20b_storms(KT, gpu="cuda"):
    """20b: each storm's run_storm at its --smoke settings in this process,
    gated as its main() gates it (the timing bars included, on the card,
    but for PHASE20_TIMING_REPORTED's, printed), with the scheduler
    kernels' counters from 0 over each storm: K1 must launch in every one
    (the embedded GCS's rounds)."""
    import importlib

    res, launches = {}, {}
    for name, kw, gate in PHASE20_STORMS:
        mod = importlib.import_module(f"ray_tpu_torch.scripts.{name}")
        KT.reset_launch_counts()
        t0 = time.perf_counter()
        rec = mod.run_storm(**kw)
        secs = time.perf_counter() - t0
        got = KT.launch_counts()
        launches[name] = {k: got[k] for k in PHASE20_SCHED_KERNELS}
        res[name] = {"s": secs, "pass": rec[gate], "record": rec}
        log(f"phase 20b {name}: {secs:.1f} s, {gate} {rec[gate]}, launches "
            f"{launches[name]}: {json.dumps(rec)}")
        exact = (rec["lost"] == rec["duplicates"] == rec["value_errors"] == 0
                 if name == "serve_storm" else
                 rec["gates"]["invariants_clean"] and rec["gates"].get(
                     "zero_silent_drops", rec["gates"].get("all_resolved")))
        if not exact:
            raise AssertionError(f"phase 20b: {name} lost, duplicated or left work "
                                 f"unresolved: {json.dumps(rec)}")
        if gpu == "cuda" and not rec[gate] and name not in PHASE20_TIMING_REPORTED:
            raise AssertionError(f"phase 20b: {name} is RED on its main's gates: "
                                 f"{json.dumps(rec)}")
        if gpu == "cuda" and launches[name]["schedule_classes"] == 0:
            raise AssertionError(f"phase 20b: K1 never launched in {name}: {got}")
        require_fused(refresh_forms({}, launches[name]), f"phase 20b {name} (scan rounds)")
    return res, launches


def _phase20_start(args, name, cwd=None):
    """Start `python -m <args>` with a directory of its own (its cwd unless
    `cwd` is given; "{dir}" in `args` names it), its output to files there;
    returns (process, directory, start time)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix=f"phase20-{name}-")
    args = [a.replace("{dir}", tmp) for a in args]
    with open(os.path.join(tmp, "out"), "w") as out, \
            open(os.path.join(tmp, "err"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", *args], cwd=cwd or tmp,
                                env=_phase20_env(tmp), stdout=out, stderr=err)
    return proc, tmp, time.perf_counter()


def _phase20_wait(started, timeout=400):
    """Wait for every process _phase20_start started ({name: started});
    kill what outlives `timeout` s. Returns {name: (exit code, seconds)},
    each process's seconds to its own end."""
    ended = {}
    while len(ended) < len(started):
        for name, (proc, _tmp, t0) in started.items():
            if name in ended:
                continue
            if proc.poll() is not None:
                ended[name] = (proc.returncode, time.perf_counter() - t0)
            elif time.perf_counter() - t0 > timeout:
                proc.kill()
                proc.wait(timeout=30)
                ended[name] = ("killed at its deadline", time.perf_counter() - t0)
        time.sleep(0.2)
    return ended


def _phase20_finish(started, ended, what):
    """(seconds, stdout) of a process _phase20_wait saw end, or raise with
    its output's end when it failed."""
    _proc, tmp, _t0 = started
    rc, secs = ended
    with open(os.path.join(tmp, "out")) as f:
        out = f.read()
    if rc != 0:
        with open(os.path.join(tmp, "err")) as f:
            err = f.read()
        raise AssertionError(f"phase 20: {what} exited {rc}: {out[-3000:]} {err[-3000:]}")
    return secs, out


def phase20c_lint_gate(started, ended):
    """20c: `python -m ray_tpu_torch.scripts.lint_gate --rpc-budget`: the
    linter clean against the port's empty baseline, the protocol
    round-tripping, and the RPC budget measured on an embedded cluster
    whose GCS runs on the card."""
    secs, out = _phase20_finish(started, ended, "lint_gate --rpc-budget")
    for needle in ("lint: clean", "baseline: empty", "round-trips",
                   "measured frames fit the committed budget"):
        if needle not in out:
            raise AssertionError(f"phase 20c: no {needle!r} in {out[-3000:]}")
    with open(os.path.join(started[1], "artifacts", "rpc_budget.json")) as f:
        measured = json.load(f)["measured"]
    log("phase 20c: " + " | ".join(ln.strip() for ln in out.splitlines()))
    return {"s": secs, "rpcs_per_op": measured}


def phase20d_soaks(started, ended):
    """20d: chaos_soak, gcs_soak, data_soak, serve_soak and workflow_soak,
    each `python -m` in a process of its own, at the shortest durations
    their argv takes: each exits 0 with its errors at 0; the chaos soak's
    invariant check is clean; the GCS soak's restarts (each builds the
    card's policy anew) are counted."""
    import ast
    import re

    res = {}
    for name, _argv in PHASE20_SOAKS:
        secs, out = _phase20_finish(started[name], ended[name], name)
        rec = {"s": secs}
        if name == "workflow_soak":
            m = re.search(r"^completed after (\d+) attempts$", out, re.M)
            if "WF SOAK OK" not in out or not m:
                raise AssertionError(f"phase 20d: {name}: {out[-3000:]}")
            rec["attempts"] = int(m.group(1))
        else:
            (line,) = [ln for ln in out.splitlines() if ln.startswith("FINAL: ")]
            rec["final"] = ast.literal_eval(line[len("FINAL: "):])
            errors = rec["final"].get("errors", rec["final"].get("handle_err"))
            if errors != 0:
                raise AssertionError(f"phase 20d: {name} counted errors: {line}")
        if name == "chaos_soak":
            m = re.search(r"^protocol trace: .* \((\d+) violations\)$", out, re.M)
            if not m or int(m.group(1)) != 0 or "SOAK DONE; task errors: 0" not in out:
                raise AssertionError(f"phase 20d: chaos_soak's invariant check: {out[-3000:]}")
            rec["invariant_violations"] = 0
        if name == "gcs_soak":
            rec["restarts"] = rec["final"]["restarts"]
        res[name] = rec
        log(f"phase 20d {name}: {secs:.1f} s, {json.dumps(rec)}")
    return res


def phase20(KT, gpu="cuda"):
    """Phase 20: 20a-20d with PHASE20_ENV in this process's environment,
    and so in every process the parts start (20c's and 20d's processes in
    PHASE20_GROUPS), each part's seconds, the phase within
    PHASE20_BUDGET_S. Returns the results and the scheduler kernels'
    launches of each storm."""
    t_phase = time.perf_counter()
    res = {}
    env = dict(PHASE20_ENV)
    if gpu != "cuda":
        env["RAY_TPU_scheduler_device"] = gpu
    with _environ(env):
        for part, fn in (("20a", lambda: phase20a_cli(gpu)),
                         ("20b", lambda: phase20b_storms(KT, gpu))):
            t0 = time.perf_counter()
            res[part] = fn()
            res[part + "_s"] = time.perf_counter() - t0
            log(f"phase {part}: {res[part + '_s']:.1f} s")
        # 20c's and 20d's processes in PHASE20_GROUPS, a group's at once
        t0 = time.perf_counter()
        argvs = {"lint_gate": ["ray_tpu_torch.scripts.lint_gate", "--rpc-budget",
                               "--artifact-dir", "{dir}/artifacts"],
                 **{name: [f"ray_tpu_torch.scripts.{name}", *argv]
                    for name, argv in PHASE20_SOAKS}}
        started, ended = {}, {}
        for group in PHASE20_GROUPS:
            # lint_gate from the checkout, as a user runs it: it names the
            # package to its RPC flow graph by a path relative to the cwd
            now = {name: _phase20_start(argvs[name], name,
                                        cwd=HERE if name == "lint_gate" else None)
                   for name in group}
            ended.update(_phase20_wait(now))
            started.update(now)
        res["20c"] = phase20c_lint_gate(started["lint_gate"], ended["lint_gate"])
        res["20d"] = phase20d_soaks(started, ended)
        res["20cd_s"] = time.perf_counter() - t0
        log(f"phase 20c-d: {res['20cd_s']:.1f} s")
    res["20b"], launches = res["20b"]
    res["phase_s"] = time.perf_counter() - t_phase
    if gpu == "cuda" and res["phase_s"] > PHASE20_BUDGET_S:
        raise AssertionError(f"phase 20 took {res['phase_s']:.1f} s, over its budget "
                             f"{PHASE20_BUDGET_S} s")
    return res, launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if sys.argv[1:2] == [PHASE17_NO_ARROW_ARG]:  # 17a's subprocess (the CPU rehearsal's too)
        sys.path.insert(0, HERE)
        return phase17a_no_arrow_main()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ray_tpu_torch")):
        print("chip_smoke: the ray_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if sys.argv[1:] == [BUSY_SHARE_ARG]:
        from ray_tpu_torch.models import moe as PM
        from ray_tpu_torch.parallel import tpu_train as TT

        return moe_busy_share_main(torch, PM, TT)
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.sched import _build, kernel_np, policy as policy_mod
    from ray_tpu_torch.sched import kernel_shard as KS, kernel_torch as KT
    from ray_tpu_torch.models import kernels as MK, transformer as PT
    from ray_tpu_torch.models import moe as PM, moe_kernels as EK
    from ray_tpu_torch.parallel import make_forward_step, tpu_train as TT
    from ray_tpu_torch import _native
    from ray_tpu_torch.rllib import prng, rllib_kernels as RK
    from ray_tpu_torch.util import cuda_build

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    # the cluster's native shm object store and the dashboard's native client
    # (host C++, one g++ each) beside the kernels' nvcc builds, all started
    # together
    libraries = [_build.LIBRARY, MK.LIBRARY, MK.LIBRARY_SM90, EK.LIBRARY, RK.LIBRARY,
                 _native.OBJECT_STORE, _native.NATIVE_CLIENT]
    cuda_build.build_all(libraries)
    log(f"phase 0 build: {time.perf_counter() - t0:.2f} s (" + "; ".join(
        f"{lib.name} {lib.build_seconds:.2f} s -> {lib.library_path().name}"
        for lib in libraries) + ")")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    a_call = phase1_kernels_a_call(torch, KT, MK, dev)
    rec = phase1_kernels(torch, KT, KS, kernel_np, dev)
    rec["compact_nonzero"].update(a_call["compact_nonzero"])
    log(f"phase 1: {time.perf_counter() - t0:.1f} s")

    # the main path: counters from 0, read after phase 4
    guard_records = []

    class _Guard(logging.Handler):
        def emit(self, record):
            if "violated scheduling invariant" in record.getMessage():
                guard_records.append(record.getMessage())

    plog = logging.getLogger(policy_mod.__name__)
    plog.addHandler(_Guard(level=logging.WARNING))
    KT.reset_launch_counts()
    t0 = time.perf_counter()
    stream = {algo: phase2_stream(torch, KT, dev, algo=algo) for algo in KT.ALGOS}
    after2 = KT.launch_counts()
    log(f"phase 2: {time.perf_counter() - t0:.1f} s, launches {after2}")
    t0 = time.perf_counter()
    phase3_policy_lockstep(torch, policy_mod, Config)
    after3 = KT.launch_counts()
    log(f"phase 3: {time.perf_counter() - t0:.1f} s, launches {after3}")
    require_fused(refresh_forms(after2, after3), "phase 3 (scan)")
    t0 = time.perf_counter()
    phase4_entry_points(torch, KT)
    after4 = KT.launch_counts()
    log(f"phase 4: {time.perf_counter() - t0:.1f} s, launches {after4}")
    require_fused(refresh_forms(after3, after4), "phase 4 (scan)")
    t0 = time.perf_counter()
    gcs = phase5_gcs(torch, KT)
    launches = KT.launch_counts()
    log(f"phase 5: {time.perf_counter() - t0:.1f} s, launches {launches}")
    if guard_records:
        raise AssertionError(f"invariant guard fired: {guard_records}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # the model payload: its kernels against their plain versions, then its
    # main path (the forward, direct and served) with the counters from 0,
    # then the checks of what it gave, outside the counting window
    t0 = time.perf_counter()
    model_rec = phase6a_model_kernels(torch, MK, dev)
    model_rec["rope_split"].update(a_call["rope_split"])
    log(f"phase 6a: {time.perf_counter() - t0:.1f} s")
    MK.reset_launch_counts()
    t0 = time.perf_counter()
    fwd_res, ctx = phase6b_forward(torch, PT, make_forward_step, dev)
    log(f"phase 6b: {time.perf_counter() - t0:.1f} s, launches {MK.launch_counts()}")
    log(f"forward [8, 2048] bf16 on {card}: {fwd_res['forward_ms']:.3f} ms, "
        f"{fwd_res['tokens_per_s']:.0f} tokens/s")
    t0 = time.perf_counter()
    serve_res, requests, answers = phase6c_serve(ctx)
    model_launches = MK.launch_counts()
    log(f"phase 6c: {time.perf_counter() - t0:.1f} s, launches {model_launches}")
    missing = [k for k in FORWARD_KERNELS if model_launches[k] == 0]
    if missing:
        raise AssertionError(f"model kernels never launched on the forward's path: {missing}")
    model_tc = MK.tc_launch_counts()
    if model_tc["attention"] != model_launches["attention"]:
        raise AssertionError(f"forward's path: {model_launches['attention']} K8 launches, "
                             f"{model_tc['attention']} of them on the tensor cores")
    log(f"phase 6b-6c tensor-core launches {model_tc}")
    t0 = time.perf_counter()
    check_res = phase6d_checks(torch, PT, MK, ctx, requests, answers)
    log(f"phase 6d: {time.perf_counter() - t0:.1f} s")

    # the expert layer: its kernels against their plain versions, then its
    # main path (moe_ffn, direct and served) with the counters from 0, then
    # the checks of what it gave, outside the counting window
    t0 = time.perf_counter()
    moe_rec = phase7a_moe_kernels(torch, PM, EK, dev)
    log(f"phase 7a: {time.perf_counter() - t0:.1f} s")
    EK.reset_launch_counts()
    t0 = time.perf_counter()
    moe_res, moe_ctx = phase7b_moe(torch, PM, dev)
    log(f"phase 7b: {time.perf_counter() - t0:.1f} s, launches {EK.launch_counts()}")
    log(f"moe_ffn [8, 2048, 256] bf16 on {card}: {moe_res['ms']:.4f} ms, "
        f"{moe_res['tokens_per_s']:.0f} tokens/s, dropped {moe_res['dropped_share']:.4f}")
    t0 = time.perf_counter()
    moe_serve, moe_requests, moe_answers = phase7c_moe_serve(torch, PM, moe_ctx)
    moe_launches = EK.launch_counts()
    log(f"phase 7c: {time.perf_counter() - t0:.1f} s, launches {moe_launches}")
    missing = [k for k in MOE_REPLACES if moe_launches[k] == 0]
    if missing:
        raise AssertionError(f"expert kernels never launched on the expert path: {missing}")
    t0 = time.perf_counter()
    moe_checks = phase7d_moe_checks(torch, PM, EK, moe_ctx, moe_requests, moe_answers)
    log(f"phase 7d: {time.perf_counter() - t0:.1f} s")

    # the sharded scheduler: K7 against its plain version, K1 and kernel_np,
    # then its path (make_sharded_scheduler on the card) with the counter
    # from 0
    t0 = time.perf_counter()
    shard_rec = phase8a_sharded_kernel(torch, KT, KS, kernel_np, dev,
                                       rec["schedule_classes"]["bound"])
    log(f"phase 8a: {time.perf_counter() - t0:.1f} s")
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    shard_res = phase8b_sharded_path(torch, KT, KS, dev)
    shard_launches = KS.launch_counts()
    log(f"phase 8b: {time.perf_counter() - t0:.1f} s, launches {shard_launches}")
    if shard_launches["schedule_classes_sharded"] == 0:
        raise AssertionError("K7 never launched on the sharded scheduler's path")

    # training: the backward kernels against their plain versions, then the
    # train step (direct, then from an actor) with the model kernels'
    # counters from 0, then the golden, outside the counting window
    t0 = time.perf_counter()
    train_rec = phase9a_train_kernels(torch, MK, dev)
    train_rec["rmsnorm_bwd"].update(a_call["rmsnorm_bwd"])
    log(f"phase 9a: {time.perf_counter() - t0:.1f} s")
    MK.reset_launch_counts()
    t0 = time.perf_counter()
    train_res, train_ctx = phase9b_train(torch, PT, TT, dev)
    log(f"phase 9b: {time.perf_counter() - t0:.1f} s, launches {MK.launch_counts()}")
    log(f"train step [8, 2048] bf16 on {card}: {train_res['step_ms_median']:.3f} ms, "
        f"{train_res['tokens_per_s']:.0f} tokens/s")
    t0 = time.perf_counter()
    train_actor = phase9c_train_actor(torch, PT, TT, train_ctx)
    train_launches = MK.launch_counts()
    log(f"phase 9c: {time.perf_counter() - t0:.1f} s, launches {train_launches}")
    want = {k: n * (TRAIN_STEPS + ACTOR_STEPS) for k, n in TRAIN_LAUNCHES_PER_STEP.items()}
    got = {k: train_launches[k] for k in want}
    if got != want:
        raise AssertionError(f"training path launches {got}, predicted {want}")
    train_tc = MK.tc_launch_counts()
    if any(train_tc[k] != train_launches[k] for k in MK.TC_KERNELS):
        raise AssertionError(f"training path: K8/K8' launches {got}, on the tensor cores "
                             f"{train_tc}")
    log(f"phase 9b-9c tensor-core launches {train_tc}")
    rows = MK.rope_split_bwd.launches_rows
    if rows != train_launches["rope_split_bwd"]:
        raise AssertionError(f"training path: {train_launches['rope_split_bwd']} K10b' "
                             f"launches, {rows} of them in the rows form")
    log(f"phase 9b-9c K10b' launches in the rows form: {rows}")
    t0 = time.perf_counter()
    train_checks = phase9d_train_checks(torch, PT, TT, dev)
    log(f"phase 9d: {time.perf_counter() - t0:.1f} s")

    # the expert layer's training: its backward kernels against their plain
    # versions, then the train step (direct, then from an actor) with the
    # expert kernels' counters from 0, then the golden, outside the window
    t0 = time.perf_counter()
    moe_bwd_rec = phase10a_moe_bwd_kernels(torch, PM, EK, dev)
    log(f"phase 10a: {time.perf_counter() - t0:.1f} s")
    EK.reset_launch_counts()
    t0 = time.perf_counter()
    moe_train_res, moe_train_ctx = phase10b_moe_train(torch, PM, TT, dev)
    log(f"phase 10b: {time.perf_counter() - t0:.1f} s, launches {EK.launch_counts()}")
    log(f"expert train step [8, 2048, 256] bf16 on {card}: "
        f"{moe_train_res['step_ms_median']:.4f} ms by events, "
        f"{moe_train_res['wall_ms_median']:.4f} ms by the host clock, "
        f"{moe_train_res['tokens_per_s']:.0f} tokens/s, device busy "
        f"{moe_train_res['device_busy_share']:.3f}")
    t0 = time.perf_counter()
    moe_train_actor = phase10c_moe_train_actor(torch, PM, TT, moe_train_ctx)
    moe_train_launches = EK.launch_counts()
    log(f"phase 10c: {time.perf_counter() - t0:.1f} s, launches {moe_train_launches}")
    # one launch of each of K9a-c and K9a'-c' a step
    want = {k: MOE_TRAIN_STEPS + MOE_ACTOR_STEPS for k in EK.KERNELS}
    if moe_train_launches != want:
        raise AssertionError(f"expert training path launches {moe_train_launches}, "
                             f"predicted {want}")
    t0 = time.perf_counter()
    moe_train_checks = phase10d_moe_train_checks(torch, PM, EK, moe_train_ctx)
    log(f"phase 10d: {time.perf_counter() - t0:.1f} s")

    # the paths across ranks: 4 processes on this card, their counters from
    # 0 over their window; then the checks of what they gave, here
    t0 = time.perf_counter()
    ranks_res, k7r_rec = phase11_ranks(torch, KT, KS, MK, PM, EK, kernel_np, dev)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s (4 processes on one card over gloo), "
        f"launches {ranks_res['launches']}")

    # training across ranks: 4 processes on this card, their counters from 0
    # over their window; then the checks of what they gave, here
    t0 = time.perf_counter()
    mesh_train = phase12_train_ranks(torch, PT, TT, PM, dev)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s (4 processes on one card over gloo), "
        f"launches {mesh_train['launches']}")

    # cluster mode: the GCS in this process (its scheduler kernels' counters
    # from 0), the model actor in a worker process (its own counters)
    t0 = time.perf_counter()
    cluster_res, head13, worker13 = phase13_cluster(KT, ctx, requests, answers)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s, launches in this process {head13}, "
        f"in the model actor's worker {worker13}")

    # the serving path: serve's fast path and a compiled graph in a cluster
    # of their own; the GCS's counters from 0 in this process, the
    # replica's and the stage's workers their own
    t0 = time.perf_counter()
    serving_res, head14, replica14, stage14 = phase14_serve(KT, ctx, requests, answers)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s, launches in this process {head14}, "
        f"in the replica's worker {replica14}, in the stage's worker {stage14}")
    log(f"phase 14 on {card}: first answer {serving_res['first_answer_s']:.3f} s, "
        f"8 requests through the fast path {serving_res['fastpath_8_requests_s']:.3f} s, "
        f"compiled graph {serving_res['cross_node_ms_median']:.3f} ms an iteration "
        f"(same node {serving_res['same_node_ms_median']:.3f} ms), cross-node edge "
        f"{serving_res['cross_node_edge_ms_median']:.3f} ms, phase "
        f"{serving_res['phase_s']:.1f} s")
    if guard_records:
        raise AssertionError(f"invariant guard fired: {guard_records}")

    # the Train library: JaxTrainer's workers in a cluster of their own, each
    # worker's model-kernel counters from 0 in its fresh process, read
    # through WorkerGroup.execute when its group shuts down
    t0 = time.perf_counter()
    train_lib, launches15a, launches15c = phase15_train(torch, PT, TT, train_ctx)
    a, b = train_lib["15a"], train_lib["15c"]
    log(f"phase 15: {time.perf_counter() - t0:.1f} s, launches in 15a's workers "
        f"{launches15a}, in 15c's {launches15c}")
    log(f"phase 15 on {card}: first step {a['first_step_s'][0]:.3f} s and "
        f"{a['first_step_s'][1]:.3f} s (the resumed worker), set-up {a['setup_s']} s; "
        f"step {a['step_ms_host']} ms by the host clock; checkpoint "
        f"{a['checkpoint_mb']:.1f} MB, saved in {a['save_s']:.3f} s, its report "
        f"{a['report_s']:.3f} s, loaded in {a['load_s']:.3f} s; restart "
        f"{a['restart_s']:.3f} s; 15c first steps {b['first_step_s']} s, step ms by rank "
        f"{b['step_ms_host_by_rank']} (2 workers sharing the card over gloo); store "
        f"{train_lib['store_by_attempt']}; phase {train_lib['phase_s']:.1f} s")

    # RLlib and Tune: the RL kernels against their plain versions, then the
    # Algorithm at full width in a local runtime (the counters from 0 over
    # PG, PPO twice and DQN), then a Tune sweep of PPO trials sharing the card
    t0 = time.perf_counter()
    rl_rec = phase16a_rl_kernels(torch, RK, prng, dev)
    log(f"phase 16a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rllib_res, rl_launches = phase16b_rllib(torch, RK, prng)
    log(f"phase 16b: {time.perf_counter() - t0:.1f} s, launches {rl_launches}")
    t0 = time.perf_counter()
    tune_res = phase16c_tune()
    log(f"phase 16c: {time.perf_counter() - t0:.1f} s")
    log(f"phase 16 on {card}: " + "; ".join(
        f"{name} sample s {[round(r['sample_time_s'], 4) for r in its]}, update s "
        f"{[round(r['update_time_s'], 4) for r in its]}"
        for name, its in rllib_res.items() if name in ("pg", "ppo", "ppo_runners_on_cpu", "dqn"))
        + f"; tune {tune_res['fit_s']:.1f} s over {len(tune_res['trials'])} trials, "
        f"{tune_res['stopped_early']} stopped by ASHA")

    # Data, Workflow and the host utilities: batch inference through an
    # actor pool, a Dataset into a train worker, a durable workflow, a queue
    # and a pool, each with the model kernels' counters from 0 over its part
    t0 = time.perf_counter()
    data_res, launches17 = phase17(torch, PT, TT, MK, ctx)
    log(f"phase 17: {time.perf_counter() - t0:.1f} s, launches by part {launches17}")
    a17, b17 = data_res["17a"], data_res["17b"]
    log(f"phase 17 on {card}: 17a {a17['rows_per_s']:.1f} rows/s through Data "
        f"({a17['tokens_per_s']:.0f} tokens/s; {a17['rows_per_s_after_setup']:.1f} rows/s "
        f"after the actors' set-up {a17['actor_setup_s']} s) against 6b's "
        f"{fwd_res['tokens_per_s']:.0f} tokens/s direct; 17b the worker's wait for a batch "
        f"{b17['wait_ms']} ms (first {b17['first_wait_ms']:.1f}) against its steps "
        f"{b17['step_ms']} ms; phase {data_res['phase_s']:.1f} s")

    # the autoscaler, the state API and the dashboard: 18a's decision on the
    # card, then clusters scaled up and down with the GCS's counters from 0
    t0 = time.perf_counter()
    scale_res, head18, gpu18 = phase18(torch, KT, kernel_np, dev)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s, launches in this process {head18}, "
        f"K1 in the GPU tasks' workers {gpu18}")
    a18, b18, c18 = scale_res["18a"], scale_res["18b"], scale_res["18c"]
    log(f"phase 18 on {card}: 18a launch {a18['launch']}, kernel_np "
        f"{a18['by_threshold']['1.0']['kernel_np_host_ms']:.1f} ms on the host against K1 "
        f"{a18['by_threshold']['1.0']['k1_ms']:.4f} ms; 18b first launch "
        f"{b18['first_launch_s']:.2f} s after the first submit, scale-down "
        f"{b18['scale_down_s']:.2f} s, {b18['topology_changes']} topology changes, "
        f"18c {c18['topology_changes']}, {scale_res['discarded_windows']} pipelined windows "
        f"discarded for another topology; phase {scale_res['phase_s']:.1f} s")

    # the analysis plane: the model checker exploring a GCS whose rounds run
    # K1 on the card, the models and gates, the sanitizers around a cluster
    # whose GCS runs on the card, the linter over the package
    t0 = time.perf_counter()
    analysis_res, launches19 = phase19(KT, policy_mod)
    a19, c19, d19 = analysis_res["19a"], analysis_res["19c"], analysis_res["19d"]
    log(f"phase 19: {time.perf_counter() - t0:.1f} s, launches {launches19}")
    log(f"phase 19 on {card}: 19a {a19['part_s']:.1f} s ("
        + ", ".join(f"{n} {s['card_s']:.2f} s card / {s['cpu_s']:.2f} s CPU, K1 "
                    f"{s['launches']['schedule_classes']} in {s['rounds_with_work']} rounds"
                    for n, s in a19["scenarios"].items())
        + f"; {a19['seeded']['bug']} found on the card, shrunk to "
        f"{a19['seeded']['shrunk_steps']} steps), 19b {analysis_res['19b']['part_s']:.1f} s, "
        f"19c {c19['part_s']:.1f} s ({c19['races']} races over {c19['watched_fields']} "
        f"fields, {c19['wait_cycles']} wait cycles, {c19['stalls']} stalls, "
        f"{c19['lock_order_cycles']} lock-order cycles, {c19['invariant_violations']} "
        f"invariant violations), 19d {d19['s']:.1f} s over {d19['files_scanned']} files; "
        f"phase {analysis_res['phase_s']:.1f} s")

    # the CLI and the scripts: a head started by the CLI, the storms, the
    # analysis gate and the soaks, every cluster's GCS on the card
    t0 = time.perf_counter()
    scripts_res, launches20 = phase20(KT)
    a20, b20, c20, d20 = (scripts_res[p] for p in ("20a", "20b", "20c", "20d"))
    log(f"phase 20: {time.perf_counter() - t0:.1f} s, launches by storm {launches20}")
    log(f"phase 20 on {card}: 20a {scripts_res['20a_s']:.1f} s (head up in "
        f"{a20['head_up_s']:.2f} s, nvidia-smi's compute apps {a20['gpu_apps_before']} before "
        f"it, {a20['gpu_apps_with_head']} with it, {a20['gpu_apps_after_stop']} after stop, "
        f"{a20['head_rounds']:.0f} GCS rounds, "
        f"{a20['head_rounds_microbenchmark']:.0f} over the microbenchmark: "
        + ", ".join(f"{k} {v}" for k, v in a20["microbenchmark"].items())
        + f"), 20b {scripts_res['20b_s']:.1f} s ("
        + ", ".join(f"{n} {r['s']:.1f} s K1 {launches20[n]['schedule_classes']} K2 "
                    f"{launches20[n]['scatter_rows']} ({launches20[n]['scatter_rows_fused']} "
                    f"in K1's launch) K3 {launches20[n]['delta_clip']} "
                    f"({launches20[n]['delta_clip_fused']} in K1's launch)"
                    for n, r in b20.items())
        + f"), 20c {c20['s']:.1f} s and 20d at once {scripts_res['20cd_s']:.1f} s ("
        + ", ".join(f"{n} {r['s']:.1f} s" for n, r in d20.items())
        + f"; {d20['gcs_soak']['restarts']} GCS restarts); phase "
        f"{scripts_res['phase_s']:.1f} s")
    if guard_records:
        raise AssertionError(f"invariant guard fired: {guard_records}")

    replaces = {
        "schedule_classes": "ray_tpu/sched/kernel_jax.py:154",
        "scatter_rows": "ray_tpu/sched/kernel_jax.py:451",
        "delta_clip": "ray_tpu/sched/kernel_jax.py:474",
        "scatter_rows_fused": "ray_tpu/sched/kernel_jax.py:451",
        "delta_clip_fused": "ray_tpu/sched/kernel_jax.py:474",
        "compact_nonzero": "ray_tpu/sched/kernel_jax.py:546",
        "schedule_classes_rounds": "ray_tpu/sched/kernel_jax.py:317",
        "schedule_classes_chunked": "ray_tpu/sched/kernel_jax.py:367",
    }
    modes = {"scatter_rows": "rows", "delta_clip": "delta"}
    kernels = []
    for name, r in rec.items():
        kernels.append({
            "name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
        if "view_build" in r:  # K2 and K3 alone: refresh_view_kernel's modes
            kernels[-1].update(kernel=f"refresh_view_kernel ({modes[name]} mode)",
                               view_build_ms_in_turns=r["view_build"],
                               launches_standalone=launches[name] - launches[f"{name}_fused"])
        if name in FUSED_REFRESH:  # K2 and K3 in K1's launch: ms is what they add to it
            kernels[-1].update({k: r[k] for k in (
                "kernel", "standalone", "k1_ms_in_turns", "k1_with_refresh_ms_in_turns",
                "pair_ms_in_turns", "pair_minus_fused_ms", "no_pass_ms_in_turns",
                "no_pass_minus_k1_no_pass_ms")})
        if name == "schedule_classes":
            kernels[-1]["at_phase20_shapes"] = r["at_phase20_shapes"]
    for name, r in model_rec.items():
        entry = {
            "name": name, "route": "cuda",
            "source": SM90_CU_SOURCE if name in SM90_MODEL_KERNELS else MODEL_CU_SOURCE,
            "replaces": MODEL_REPLACES[name], "launches": model_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        }
        if name not in FORWARD_KERNELS:  # the ring across ranks runs it: its
            # launches are phase 11's; 6d's ring check's stay apart
            entry.update(launches=ranks_res["launches"][name],
                         ring_check_launches=check_res["ring_block_update_launches"],
                         ring_check_launches_tc=check_res["ring_block_update_launches_tc"],
                         ms_f32_cuda_core=r["ms_f32_cuda_core"])
        kernels.append(entry)
    for name, r in moe_rec.items():
        kernels.append({
            "name": name, "route": "cuda", "source": MOE_CU_SOURCE,
            "replaces": MOE_REPLACES[name], "launches": moe_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    for name, r in moe_bwd_rec.items():
        kernels.append({
            "name": name, "route": "cuda", "source": MOE_CU_SOURCE,
            "replaces": MOE_BWD_REPLACES, "launches": moe_train_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    for name, r in train_rec.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": SM90_CU_SOURCE if name == "attention_bwd" else MODEL_CU_SOURCE,
            "replaces": TRAIN_REPLACES[name], "launches": train_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    r = shard_rec
    kernels.append({
        "name": "schedule_classes_sharded", "route": "cuda", "source": CU_SOURCE,
        "replaces": SHARD_REPLACES, "launches": shard_launches["schedule_classes_sharded"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
    })
    kernels.append({
        "name": "rank_pass", "route": "cuda", "source": CU_SOURCE,
        "replaces": K7R_REPLACES, "launches": k7r_rec["launches"],
        "max_abs_err": k7r_rec["max_abs_err"], "ms": k7r_rec["ms"],
        "plain_ms": k7r_rec["plain_ms"], "bound_ms": k7r_rec["bound"][0],
        "bound_by": k7r_rec["bound"][1], "library_ms": k7r_rec["library_ms"],
        "kernel": "k7r_kernel<MODE> (K7r: terms, caps, fill a pass)",
        "ms_by_step": k7r_rec["ms_by_step"], "plain_ms_by_step": k7r_rec["plain_ms_by_step"],
    })
    for name, rl in rl_rec.items():
        kernels.append({
            "name": name, "route": "cuda", "source": RL_CU_SOURCE,
            "replaces": RL_REPLACES[name], "launches": rl_launches[name],
            "max_abs_err": rl["max_abs_err"], "ms": rl["ms"], "plain_ms": rl["plain_ms"],
            "bound_ms": rl["bound"][0], "bound_by": rl["bound"][1],
            "library_ms": rl["library_ms"], "shape": rl["shape"],
            **{k: rl[k] for k in ("mode", "ms_pg_mode", "ms_plain_pg_mode", "ms_batch_128",
                                  "ms_hidden_128_tiled", "cluster", "near_ties_skipped",
                                  "against_plain", "smem_bytes") if k in rl},
            **({"replaces_ppo": RL_REPLACES_PPO} if name == "pg_update" else {}),
            "phase16c_launches": sum(t["launches"][name] for t in tune_res["trials"]),
        })
    log(json.dumps({"stream": stream, "gcs": gcs, "forward": fwd_res, "serve": serve_res,
                    "checks": check_res, "moe": moe_res, "moe_serve": moe_serve,
                    "moe_checks": moe_checks, "sharded": shard_res,
                    "sharded_ms_by_shards": r["ms_by_shards"], "train": train_res,
                    "train_actor": train_actor, "train_golden": train_checks,
                    "moe_train": moe_train_res, "moe_train_actor": moe_train_actor,
                    "moe_train_checks": moe_train_checks, "ranks": ranks_res,
                    "train_across_ranks": mesh_train, "cluster": cluster_res,
                    "serving": serving_res, "train_library": train_lib,
                    "rllib": rllib_res, "tune": tune_res, "data_workflow": data_res,
                    "autoscaler_state_dashboard": scale_res, "analysis": analysis_res,
                    "scripts": {**scripts_res, "20b": {
                        n: {k: v for k, v in r.items() if k != "record"}
                        for n, r in scripts_res["20b"].items()}},
                    "attention_ms_unrounded": model_rec["attention"]["ms_unrounded"],
                    "attention_ms_f32_cuda_core": model_rec["attention"]["ms_f32_cuda_core"],
                    "attention_bwd_ms_f32_cuda_core":
                        train_rec["attention_bwd"]["ms_f32_cuda_core"],
                    "tc_launches": {"forward": model_tc, "train": train_tc},
                    "round_refresh_enqueued": a_call["view_build"],
                    "card": card}))
    for entry in kernels:  # phase 12's launches, summed over its four ranks
        if entry["name"] in PHASE12_KERNELS:
            entry["phase12_launches"] = mesh_train["launches"][entry["name"]]
    phase13 = {**head13, **worker13}
    for entry in kernels:  # phase 13's, in the GCS's process or the actor's
        if entry["name"] in phase13:
            entry["phase13_launches"] = phase13[entry["name"]]
    for entry in kernels:  # phase 14's: the GCS's process, the replica's and
        # the stage's workers (the forward's kernels summed over the two)
        name = entry["name"]
        if name in head14:
            entry["phase14_launches"] = head14[name]
        if name in replica14:
            entry["phase14_launches"] = replica14[name] + stage14[name]
            entry["phase14_launches_by_process"] = {"replica": replica14[name],
                                                    "stage": stage14[name]}
    for entry in kernels:  # phase 15's: 15a's two workers and 15c's two ranks
        name = entry["name"]
        if name in launches15a:
            entry["phase15_launches"] = launches15a[name] + launches15c[name]
            entry["phase15_launches_by_part"] = {"15a": launches15a[name],
                                                 "15c": launches15c[name]}
    for entry in kernels:  # phase 17's: 17a's pool, 17b's train worker, 17c's
        # workflow task, 17d's queue and pool
        name = entry["name"]
        if name in TRAIN_KERNELS:
            by_part = {p: launches17[p].get(name, 0) for p in ("17a", "17b", "17c", "17d")}
            entry["phase17_launches"] = sum(by_part.values())
            entry["phase17_launches_by_part"] = by_part
    for entry in kernels:  # phase 18's: the GCS's process over 18b-18c, and
        # K1 in the autoscaled GPU node's task workers
        name = entry["name"]
        if name in head18:
            entry["phase18_launches"] = head18[name]
        if name == "schedule_classes":
            entry["phase18_gpu_task_launches"] = gpu18
    for entry in kernels:  # phase 19's: the explorer's rounds (19a) and the
        # sanitized cluster's GCS (19c); phase 20's: each storm's GCS (20b)
        name = entry["name"]
        if name in PHASE20_SCHED_KERNELS:
            by19 = {p: launches19[p][name] for p in ("19a", "19c")}
            entry["phase19_launches"] = sum(by19.values())
            entry["phase19_launches_by_part"] = by19
            by20 = {n: launches20[n][name] for n in launches20}
            entry["phase20_launches"] = sum(by20.values())
            entry["phase20_launches_by_storm"] = by20
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
