"""Time the corpus replays of ``tests/chaos_seeds/`` on the CPU: the six
files clean and armed, through the JAX package or the port
(``device="cpu"``), after one warm-up replay that is not counted.

    JAX_PLATFORMS=cpu python tests/torch_chaos_replay_times.py jax
    python tests/torch_chaos_replay_times.py port
    python tests/torch_chaos_replay_times.py port-scalar

``port-scalar`` replays through the port with the oracle's CRCs taken by
the scalar ``crc32c_py`` one payload at a time (the route before the
oracle went through ``crc32c_many``), for a before/after comparison.
Prints one line a replay and the total; CPU times say nothing of the
card."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _scalar_oracle() -> None:
    from tpu3fs_torch.chaos import invariants, search
    from tpu3fs_torch.ops.crc32c import crc32c_py

    search.FabricRunner._crc = lambda self, data: crc32c_py(data)
    invariants._crc32c_many = lambda bufs, device: [crc32c_py(b)
                                                    for b in bufs]


def main(mode: str) -> int:
    if mode == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from tpu3fs.chaos.search import load_corpus, replay_seed

        kw = {}
    else:
        from tpu3fs_torch.chaos.search import load_corpus, replay_seed

        kw = {"device": "cpu"}
        if mode == "port-scalar":
            _scalar_oracle()
        elif mode != "port":
            raise SystemExit(f"unknown mode {mode!r}")
    corpus = load_corpus()
    replay_seed(corpus[0], with_bug=False, **kw)  # warm-up, not counted
    total = 0.0
    for path in corpus:
        for with_bug in (False, True):
            t0 = time.perf_counter()
            report, _ = replay_seed(path, with_bug=with_bug, **kw)
            secs = time.perf_counter() - t0
            total += secs
            print(f"{os.path.basename(path):40s} "
                  f"{'armed' if with_bug else 'clean'} {secs:8.4f} s "
                  f"violated {report.violated_checkers}", flush=True)
    print(f"{mode}: 12 replays {total:.4f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "port"))
