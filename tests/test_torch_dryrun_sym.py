"""The dry run's symmetries (``launch/dryrun.py``) held against the dry
run without them, on the CPU at tiny sizes (the prediction against the
port's own run is ``test_torch_dryrun_run.py``).

With the symmetries, the record (FLOPs, wire by site, event summary,
the kernels' dry calls, the arguments, outputs and aliases) equals the
dry run without them, at tiny configs raised to 4 cycles: a dense
decoder, an MoE (its "fsdp" leaves gathered over the data axis),
DeepSeek (a dense segment before the MoE one) and gemma2 (two-layer
cycles), a prefill (the MoE's too: each group's view gathers its
"fsdp" leaves, once a group), a decode step and a 2x2x2 mesh (four
data groups over "pod" and "data").  A position's temp (``temp_by_phase``) is a
lower bound, exact in every case but DeepSeek's: its group's peak grows
by more each cycle until 4 cycles (the point that sets it moves), so
the line through 2 and 3 cycles falls 43,276 bytes (1.3%) a position
under the full run at 4.
"""
import pytest

from repro_torch.configs import get_tiny_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

B, S = 4, 32


def _close(a, b, tol=1e-9):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], tol)
                                            for k in a)
    return abs(a - b) <= tol * max(abs(a), abs(b), 1.0)


CASES = [("qwen3-14b", dict(n_layers=4), "train", 1),
         ("grok-1-314b", dict(n_layers=4), "train", 1),
         ("deepseek-v3-671b", dict(n_layers=5, first_k_dense=1), "train", 1),
         ("gemma2-27b", dict(n_layers=8), "train", 1),
         ("qwen3-14b", dict(n_layers=4), "prefill", 1),
         # a group's view gathers the "fsdp" leaves: once a group
         ("grok-1-314b", dict(n_layers=4), "prefill", 1),
         ("qwen3-14b", dict(n_layers=4), "decode", 1),
         # four data groups over ("pod", "data")
         ("qwen3-14b", dict(n_layers=4), "train", 2)]


@pytest.mark.parametrize("arch,cut,kind,pod", CASES,
                         ids=[f"{a}-{k}-pod{p}" for a, _, k, p in CASES])
def test_symmetries_are_exact(arch, cut, kind, pod):
    cfg = get_tiny_config(arch).replace(**cut)
    shape = ShapeConfig("t", S, 2 * B, kind)
    mesh = make_test_mesh(2, 2, pod, devices="meta")
    sym = dryrun.dry_step(cfg, shape, mesh)
    assert sym["symmetry"]["cycles"]["cycles"] == 4
    full = dryrun.dry_step(cfg, shape, mesh, symmetry=False)
    for key in ("cost_analysis", "wire_bytes_by_site", "kernel_dry_calls"):
        assert sym[key] == full[key], key
    m, f = sym["memory"], full["memory"]
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes"):
        assert m[key] == f[key], key
    assert m["peak_bytes_mesh"] is None and f["peak_bytes_mesh"] > 0
    t, u = m["temp_by_phase"], f["temp_by_phase"]
    assert t.keys() == u.keys()
    assert all(t[k] <= u[k] for k in t)
    if arch == "deepseek-v3-671b":
        assert u["data_group"] - t["data_group"] == 43276
        assert t["optimizer"] == u["optimizer"]
    else:
        assert t == u
        assert m["temp_size_in_bytes"] == f["temp_size_in_bytes"]
    assert sym["collectives"]["op_counts"] == full["collectives"]["op_counts"]
    assert _close(sym["collectives"], full["collectives"])
