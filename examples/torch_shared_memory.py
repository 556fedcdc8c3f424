"""Case study II (Swallow §X-B) on the PyTorch port: shared memory
emulated on distributed memory — single controller vs address%n
striping, and the overlay made load-bearing: copy-on-write prefix
sharing of KV pages.

The counterpart of ``examples/shared_memory.py``.  Part 1 runs a batch
of random writes and reads against the port's ``SingleController`` and
its ``StripedStore`` on a 1x4 mesh (four positions on the one card, or
on the CPU), checks that they implement the same memory semantics bit
for bit, and prints the traffic/contention model that makes the paper
prefer striping.

Part 2 is the "more elegant strategy" grown up: the same address%n
striping carries the serving engine's KV pages, and the prefix cache
(:mod:`repro_torch.serving.prefix_cache`) overlays *sharing* on top —
requests with a common system prompt read the same physical pages
through their block tables, copy-on-write protects the divergence page,
and greedy tokens stay identical to a cache-less run.

Run:  PYTHONPATH=src python examples/torch_shared_memory.py [--device cpu]
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.memory_server import (SingleController, StripedStore,
                                            striped_owner)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.parallel.sharding import use_sharding


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def striping_demo(device):
    size = 1 << 16
    n_nodes = 16
    n_access = 4096
    g = torch.Generator(device=device).manual_seed(0)
    addrs = torch.randint(0, size, (n_access,), generator=g, device=device)
    vals = torch.randn(n_access, generator=g, device=device)

    single = SingleController(size, device=device)
    with use_sharding(make_test_mesh(1, 4, devices=device)):
        striped = StripedStore(size)

    single.write(addrs, vals)
    striped.write(addrs, vals)
    r1 = single.read(addrs)
    r2 = striped.read(addrs)
    assert torch.equal(r1, r2), "stores disagree"
    print(f"semantics check OK over {n_access} random accesses")

    print("\nowner mapping (address % n):",
          [int(striped_owner(a, n_nodes)) for a in range(8)])

    tm_s = single.traffic_model(n_access, n_nodes)
    tm_d = striped.traffic_model(n_access, n_nodes)
    print("\n                      single-controller   striped")
    print(f"remote fraction       {tm_s['remote_fraction']:<19.3f}"
          f"{tm_d['remote_fraction']:.3f}")
    print(f"contention points     {tm_s['contention_points']:<19d}"
          f"{tm_d['contention_points']}")
    print("\n-> striping removes the serialization point: remote traffic is "
          "the same,\n   but it spreads over n controllers instead of one "
          "(the paper's argument).")

    # micro-timing, on the device the stores live on
    for name, store in (("single", single), ("striped", striped)):
        store.read(addrs)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(10):
            store.read(addrs)
        _sync(device)
        dt = (time.perf_counter() - t0) / 10
        print(f"{name:>8}: {n_access / dt / 1e6:.1f} M reads/s ({device})")


def serve_shared(cfg, params, prompts, gen, *, page_size, n_pages,
                 device, max_batch=3):
    """Serve ``prompts`` (``gen`` tokens each) through the paged engine
    with the prefix cache off, then on.  Returns ``(engine, {rid:
    tokens})`` for each, off first."""
    from repro_torch.serving.engine import PagedEngine

    max_len = max(len(p) for p in prompts) + gen
    out = []
    for prefix_cache in (False, True):
        eng = PagedEngine(cfg, params, max_batch=max_batch,
                          page_size=page_size, n_pages=n_pages,
                          max_len=max_len, prefix_cache=prefix_cache,
                          device=device)
        for i, p in enumerate(prompts):
            eng.submit(p, gen, rid=f"r{i}")
        finished = eng.run()
        out.append((eng, {r.rid: list(r.tokens) for r in finished}))
    return out


def shared_prompts(vocab, n, length, shared, seed=42):
    """``n`` prompts of ``length`` tokens whose first ``shared`` (the
    system prompt) are common, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    system = rng.integers(2, vocab, shared, dtype=np.int32)
    return [np.concatenate([system, rng.integers(2, vocab, length - shared,
                                                 dtype=np.int32)])
            for _ in range(n)]


def report(off, on, shared, page_size):
    (eng_off, toks_off), (eng_on, toks_on) = off, on
    m = eng_on.metrics()
    print(f"\n{len(toks_on)} requests, shared {shared}-token system prompt "
          f"over {page_size}-token pages (address%n striped):")
    print(f"  tokens identical with cache on/off: {toks_on == toks_off}")
    print(f"  prefill tokens computed: {m['prefill_tokens']} (vs "
          f"{eng_off.metrics()['prefill_tokens']} without sharing)")
    print(f"  hit rate {m['prefix_hit_rate'] * 100:.0f}%, "
          f"{m['cow_copies']} copy-on-write page copies, "
          f"{m['shared_pages']} pages owned by the radix tree, "
          f"{m['bytes_deduped']} KV bytes deduplicated")
    print("-> the paper's DSM overlay, load-bearing: one physical page "
          "serves every tenant\n   that shares its tokens; divergence "
          "inside a page is a COW copy, never a rewrite.")


def prefix_sharing_demo(device):
    """The overlay in anger: three requests sharing a 10-token system
    prompt served through the prefix cache, checked token-for-token
    against a cache-less engine."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.weights import init_params

    cfg = get_tiny_config("tiny-100m")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    S, gen, ps, shared = 14, 4, 4, 10
    prompts = shared_prompts(cfg.vocab_size, 3, S, shared)
    off, on = serve_shared(cfg, params, prompts, gen, page_size=ps,
                           n_pages=32, device=device)
    assert on[1] == off[1], "sharing must not change a single token"
    report(off, on, shared, ps)


def main():
    from repro_torch.weights import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu to run on the host")
    device = resolve_device(ap.parse_args().device)
    striping_demo(device)
    print("\n=== §X-B overlay, applied: KV prefix sharing "
          "(docs/PREFIX_CACHE.md) ===")
    prefix_sharing_demo(device)


if __name__ == "__main__":
    main()
