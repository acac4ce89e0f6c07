"""Serve soak: sustained handle traffic across replica rescaling.

Run as: python -m ray_tpu_torch.scripts.serve_soak [seconds]. 4 hammer threads
drive a batched deployment while it is rescaled every few seconds;
handle_err must stay 0 (the router refreshes membership and resubmits on
dead replicas). The local runtime schedules with the default policy,
torch_cuda on the card.
"""
import random, sys, threading, time
import ray_tpu_torch
from ray_tpu_torch import serve


def main():
    DURATION = float(sys.argv[1]) if len(sys.argv) > 1 else 300.0
    random.seed(3)
    ray_tpu_torch.init(num_cpus=8)

    @serve.deployment(num_replicas=2, max_ongoing_requests=8)
    class Echo:
        def __init__(self):
            self.n = 0

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.02)
        def __call__(self, xs):
            self.n += len(xs)
            return [x * 2 for x in xs]

    h = serve.run(Echo.bind(), name="soak")
    stats = {"handle_ok": 0, "handle_err": 0, "rescale": 0}
    stats_lock = threading.Lock()
    stop = []

    def hammer():
        # dict += from several threads loses increments; count under a lock
        while not stop:
            i = random.randint(0, 10_000)
            try:
                r = h.remote(i).result(timeout=30)
                assert r == i * 2, (r, i)
                with stats_lock:
                    stats["handle_ok"] += 1
            except Exception as e:
                with stats_lock:
                    stats["handle_err"] += 1
                print("HANDLE ERR:", repr(e)[:120], flush=True)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads: t.start()
    t_end = time.time() + DURATION
    last = time.time()
    while time.time() < t_end:
        time.sleep(5)
        if random.random() < 0.5:
            # rescale the deployment up/down through a re-run
            n = random.choice([1, 2, 3])
            serve.run(Echo.options(num_replicas=n).bind(), name="soak")
            stats["rescale"] += 1
        if time.time() - last > 30:
            print("t=%.0f %s" % (DURATION - (t_end - time.time()), stats), flush=True)
            last = time.time()
    stop.append(1)
    for t in threads: t.join(timeout=60)
    print("FINAL:", stats, flush=True)
    serve.shutdown()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
