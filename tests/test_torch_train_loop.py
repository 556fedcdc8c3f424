"""The port's checkpoints, train loop, train CLI and training examples
on the CPU, with checkpoints crossing to and from the JAX reference.

* round trips of the port's own checkpoints: fp32 and int8 optimizer
  state, and a bf16 leaf (gemma2 tiny's parameters), bit for bit;
* a checkpoint the reference's ``save`` writes restores into the port
  (its bf16 leaves are 2-byte void records), and the port writes the
  same keys, shapes and dtypes; an fp32 (and an int8-state) checkpoint of
  the port restores into the reference's ``restore``, bit for bit;
* ``AsyncCheckpointer``: its snapshot is taken at ``save`` (a later
  in-place write does not reach the file) and it keeps the last k;
* the restart test: a run that fails at step 4 restores the step-4
  checkpoint, whose values equal the uninterrupted run's at step 4, and
  its steps 4 to 7 repeat that run's losses and final parameters bit for
  bit (the CPU's arithmetic is deterministic);
* the loss falls over 30 steps; the train CLI on ``--device cpu``, its
  mesh flags on CPU positions, and its exit-2 cases (MoE on a mesh; MLA,
  RG-LRU and RWKV-6 on a model axis; ``--impl pallas``); both examples.
"""
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as jsteps
from repro.configs import get_tiny_config as jtiny
from repro.models import lm as jlm
from repro.optim import adam as jadam, quant as jquant
from repro.runtime import checkpoint as jckpt
from repro_torch import steps, weights
from repro_torch.configs import get_tiny_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import train as train_cli
from repro_torch.optim import adam, quant
from repro_torch.runtime import checkpoint as ckpt, train_loop

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs files on several
    workers at once, and the many small CPU ops of a train step slow down
    many times over when every worker spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(arch, state_dtype, seed=0):
    """A port train state {"params": reference-shaped tree, "opt": adam
    state} with non-zero moments (one update of seeded gradients)."""
    cfg = get_tiny_config(arch)
    p = weights.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    tree = weights.to_reference(p, cfg)
    c = adam.AdamConfig(state_dtype=state_dtype)
    g = torch.Generator().manual_seed(seed + 1)
    grads = jax.tree.map(lambda t: torch.randn(t.shape, generator=g).to(
        t.dtype), tree)
    tree, opt, _ = adam.update(grads, adam.init(tree, c), tree, lr=1e-2,
                               cfg=c)
    return cfg, c, {"params": tree, "opt": opt}


def _leaves(state):
    return [("/".join(p), t) for p, t in ckpt._items(state)]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _template(cfg, c):
    p = steps.abstract_params(cfg)
    return {"params": p, "opt": steps.abstract_opt_state(cfg, c, p)}


@pytest.mark.parametrize("arch,state_dtype", [("qwen3-14b", "float32"),
                                              ("qwen3-14b", "int8"),
                                              ("gemma2-27b", "bfloat16")])
def test_checkpoint_round_trip(tmp_path, arch, state_dtype):
    cfg, c, state = _state(arch, state_dtype)
    path = ckpt.save(str(tmp_path), 7, state, extra_meta={"why": "test"})
    assert path.endswith("step_00000007") and ckpt.latest_step(
        str(tmp_path)) == 7
    step, back = ckpt.restore(str(tmp_path), _template(cfg, c),
                              device="cpu")
    assert step == 7
    _assert_same(state, back)
    man = json.loads((Path(path) / "manifest.json").read_text())
    assert man["extra"] == {"why": "test"}
    if arch == "gemma2-27b":         # bf16 parameters and moments
        key = "params/embed/embed_table"
        assert man["leaves"][key]["dtype"] == "bfloat16"
        assert np.load(Path(path) / "arrays.npz")[key].dtype == np.uint16


def _ref_state(arch, state_dtype):
    cfg = jtiny(arch)
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    c = jadam.AdamConfig(state_dtype=state_dtype)
    g = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, opt, _ = jadam.update(g, jadam.init(params, c), params,
                                  lr=1e-2, cfg=c)
    return cfg, c, {"params": params, "opt": opt}


def _ref_arrays(tree):
    out = []
    for x in jax.tree.leaves(tree):
        a = np.asarray(x)
        out.append(a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
    return out


def _port_arrays(state):
    return [t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy()
            for _, t in _leaves(state)]


@pytest.mark.parametrize("arch,state_dtype", [("qwen3-14b", "int8"),
                                              ("gemma2-27b", "float32"),
                                              ("deepseek-v3-671b",
                                               "float32")])
def test_reference_checkpoint_restores_into_the_port(tmp_path, arch,
                                                     state_dtype):
    """Keys, shapes and values of the reference's own ``save``: the
    port's template names the same leaves, and a port ``save`` of the
    restored state writes the same key set, shapes and dtypes."""
    cfg, c, state = _ref_state(arch, state_dtype)
    jckpt.save(str(tmp_path / "ref"), 3, state)
    tcfg = get_tiny_config(arch)
    tc = adam.AdamConfig(state_dtype=state_dtype)
    step, back = ckpt.restore(str(tmp_path / "ref"), _template(tcfg, tc),
                              device="cpu")
    assert step == 3 and int(back["opt"].step) == 1
    for a, b in zip(_ref_arrays(state), _port_arrays(back)):
        assert a.shape == b.shape and np.array_equal(a, b)
    for m in back["opt"].m:
        assert isinstance(m, quant.QTensor) == (state_dtype == "int8")
    ckpt.save(str(tmp_path / "port"), 3, back)
    ref_man, port_man = (json.loads(
        (tmp_path / d / "step_00000003" / "manifest.json").read_text())
        for d in ("ref", "port"))
    assert ref_man["leaves"] == port_man["leaves"]


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, state_dtype):
    cfg, c, state = _state("qwen3-14b", state_dtype)
    ckpt.save(str(tmp_path), 5, state)
    jcfg = jtiny("qwen3-14b")
    jc = jadam.AdamConfig(state_dtype=state_dtype)
    p_shape = jsteps.abstract_params(jcfg)
    step, back = jckpt.restore(str(tmp_path), {
        "params": p_shape,
        "opt": jsteps.abstract_opt_state(jcfg, jc, p_shape)})
    assert step == 5
    for a, b in zip(_ref_arrays(back), _port_arrays(state)):
        assert a.shape == b.shape and np.array_equal(a, b)
    if state_dtype == "int8":
        assert isinstance(back["opt"].m[0], jquant.QTensor)


def test_async_checkpointer_snapshots_at_save_and_keeps_the_last(tmp_path):
    cfg, c, state = _state("qwen3-14b", "float32")
    before = state["params"]["final_norm"]["scale"].clone()
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep_last=2)
    for s in range(1, 6):
        ac.save(s, state)
        state["params"]["final_norm"]["scale"].add_(1.0)   # in place, now
    ac.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000005"]
    _, back = ckpt.restore(str(tmp_path), _template(cfg, c), step=4,
                           device="cpu")
    assert torch.equal(back["params"]["final_norm"]["scale"], before + 3.0)


TINY_SHAPE = ShapeConfig("t", 32, 2, "train")


def _job(tmp, **kw):
    base = dict(steps=8, log_every=1, ckpt_every=4, ckpt_dir=str(tmp),
                peak_lr=2e-3, warmup=2, seed=0)
    base.update(kw)
    return train_loop.TrainJobConfig(**base)


def test_restart_restores_step_k_and_repeats_the_run(tmp_path):
    cfg = get_tiny_config("qwen3-14b")
    full = train_loop.run(cfg, TINY_SHAPE, job=_job(tmp_path / "a"),
                          device="cpu")

    def crash(step):
        if step == 4:
            raise RuntimeError("simulated node failure")
    with pytest.raises(RuntimeError, match="simulated"):
        train_loop.run(cfg, TINY_SHAPE, job=_job(tmp_path / "b"),
                       failure_hook=crash, device="cpu")
    assert ckpt.latest_step(str(tmp_path / "b")) == 4
    tpl = _template(cfg, steps.adam_config_for(cfg))
    _, k_crashed = ckpt.restore(str(tmp_path / "b"), tpl, device="cpu")
    _, k_full = ckpt.restore(str(tmp_path / "a"), tpl, step=4,
                             device="cpu")
    _assert_same(k_full, k_crashed)
    assert int(k_crashed["opt"].step) == 4
    # the step-4 values differ from the step-8 ones: the restore is real
    assert not torch.equal(
        k_crashed["params"]["final_norm"]["scale"],
        weights.to_reference(full["params"], cfg)["final_norm"]["scale"])

    resumed = train_loop.run(cfg, TINY_SHAPE, job=_job(tmp_path / "b"),
                             device="cpu")
    assert [h["step"] for h in resumed["history"]] == [4, 5, 6, 7]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in full["history"][4:]]
    _assert_same({"params": weights.to_reference(full["params"], cfg),
                  "opt": full["opt_state"]},
                 {"params": weights.to_reference(resumed["params"], cfg),
                  "opt": resumed["opt_state"]})


def test_loss_falls_over_thirty_steps(tmp_path):
    out = train_loop.run(
        get_tiny_config("qwen3-14b"), ShapeConfig("t", 64, 4, "train"),
        job=train_loop.TrainJobConfig(steps=30, log_every=10, peak_lr=2e-3,
                                      warmup=5,
                                      metrics_path=str(tmp_path / "m.json")),
        device="cpu")
    hist = out["history"]
    assert [h["step"] for h in hist] == [0, 9, 19, 29]
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5
    assert json.loads((tmp_path / "m.json").read_text()) == hist


def test_mesh_training_is_refused():
    """MoE on a mesh, which raised here while the sharded MoE was not
    ported, now trains: grok on a 2x1 mesh (each data group's capacity
    and load-balance loss) takes its steps to a finite loss.  What is
    still refused is a model axis that does not divide the heads."""
    from repro_torch.launch.mesh import make_test_mesh
    out = train_loop.run(get_tiny_config("grok-1-314b"), TINY_SHAPE,
                         mesh=make_test_mesh(2, 1, devices="cpu"),
                         job=train_loop.TrainJobConfig(steps=2),
                         device="cpu")
    assert np.isfinite(out["final_metrics"]["loss"])
    assert out["final_metrics"]["moe_aux"] > 0
    with pytest.raises(NotImplementedError, match="does not split"):
        train_loop.run(get_tiny_config("grok-1-314b"), TINY_SHAPE,
                       mesh=make_test_mesh(1, 3, devices="cpu"),
                       device="cpu")


def test_train_cli_on_the_cpu(tmp_path, capsys):
    train_cli.main(["--tiny", "--arch", "grok-1-314b", "--steps", "3",
                    "--seq", "32", "--batch", "2", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "final:" in out and "moe_aux" in out
    assert ckpt.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--data", "2"],
                                   ["--model", "2"],
                                   ["--devices", "4", "--layout", "auto"]])
def test_train_cli_trains_on_a_mesh(flags, capsys):
    """The mesh flags that exited 2 before the mesh trainer was ported:
    a run on CPU positions (``--devices 2`` alone is one device, as in
    the reference: no ``--data`` or ``--model`` makes no mesh)."""
    out = train_cli.main(["--tiny", "--device", "cpu", "--steps", "2",
                          "--seq", "32", "--batch", "4"] + flags)
    text = capsys.readouterr().out
    assert "final:" in text and np.isfinite(out["final_metrics"]["loss"])
    if "--layout" in flags:
        assert "[cost-engine]" in text and "TPU v5e-class" in text
    if "--devices" not in flags or "--layout" in flags:
        assert "mesh {" in text       # a mesh of CPU positions was made


@pytest.mark.parametrize("arch,flags,why", [
    ("grok-1-314b", ["--data", "2"], "trains on a mesh"),
    ("deepseek-v3-671b", ["--data", "2"], "trains on a mesh"),
    ("deepseek-v3-671b", ["--model", "2"], "trains on a mesh"),
    ("recurrentgemma-2b", ["--model", "2"], "trains on a mesh"),
    ("rwkv6-1.6b", ["--model", "2"], "trains on a mesh"),
    ("tiny-100m", ["--impl", "pallas"], "no backward")])
def test_train_cli_refuses_what_it_cannot_train(arch, flags, why, capsys):
    """``--impl pallas`` exits 2: the kernels have no backward.  The
    cases that train on a mesh (MoE on a data axis, MLA, RG-LRU and
    RWKV-6 on a model axis), which exited 2 while the mesh trainer
    refused them, train to a finite loss."""
    argv = ["--tiny", "--device", "cpu", "--arch", arch] + flags
    if why == "trains on a mesh":
        out = train_cli.main(argv + ["--steps", "2", "--seq", "32",
                                     "--batch", "4"])
        assert "mesh {" in capsys.readouterr().out
        assert np.isfinite(out["final_metrics"]["loss"])
        return
    with pytest.raises(SystemExit) as e:
        train_cli.main(argv)
    assert e.value.code == 2
    assert why in capsys.readouterr().err


def test_examples(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_quickstart
    import torch_train_lm
    out, gen = torch_quickstart.main(["--device", "cpu"])
    assert out["final_metrics"]["loss"] < out["history"][0]["loss"]
    assert len(gen) == 9 and all(0 <= t < 256 for t in gen)
    out = torch_train_lm.main(["--tiny", "--steps", "12", "--seq", "32",
                               "--batch", "2", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path / "ck"),
                               "--metrics", str(tmp_path / "m.json")])
    assert ckpt.latest_step(str(tmp_path / "ck")) == 12
    assert len(out["history"]) == 2
