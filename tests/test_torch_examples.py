"""The port's two case studies against the reference's examples on the
CPU.

* §X-A neuron simulation (``examples/torch_neuron_sim.py`` against
  ``examples/neuron_sim.py``): Fig. 11's table and
  ``max_neurons_per_core`` equal the reference's exactly.  On the
  reference's own draws (r, the excitatory mask, the connection mask and
  every step's noise, bridged through numpy) the port's parameters and
  connection table are the reference's bit for bit, and from each of the
  reference's states of a 200-step run at N=512 the port's step fires
  the same neurons and lands within 4 fp32 units of the update's largest
  term (``ULPS``) of the reference's next state: XLA's fused CPU program
  rounds ``v + dt*(0.04*v*v + 5*v + 140 - u + I)`` differently from
  eager torch (one unit at step 0).  The network is chaotic: those units
  grow into different spikes, so run on the same draws the port counts
  781 spikes against the reference's 785.  Totals are therefore held to
  ``TOTAL_TOL`` relative, never to equality.
* batched serving (``examples/torch_serve_batch.py`` against
  ``examples/serve_batch.py``): the script's served line is the
  reference's; at fp32 activations its tokens on a 1x2 and a 2x2 mesh
  are the one-device run's.
* §X-B shared memory (``examples/torch_shared_memory.py`` against
  ``examples/shared_memory.py``): both run as scripts; every line they
  print but the timing lines is equal (the store semantics, the owner
  map, the traffic table, part 2's counters).  Part 2 run on the
  reference's parameters at float32 activations gives the reference
  engine's tokens and counters.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ROOT, get_tiny_model, run_example
from repro.serving import PagedEngine as JEngine
from repro_torch.configs import get_tiny_config
from repro_torch.weights import from_reference

sys.path.insert(0, os.path.join(ROOT, "examples"))
import neuron_sim as jsim               # noqa: E402
import torch_neuron_sim as tsim         # noqa: E402
import torch_serve_batch as tserve     # noqa: E402
import torch_shared_memory as tshm      # noqa: E402

ULPS = 4            # fp32 units of the update's largest term
TOTAL_TOL = 0.02    # relative, of a chaotic run's spike total
N, STEPS, SEED = 512, 200, 0


def _run_script(name, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                        name), *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=env)


# --- §X-A ------------------------------------------------------------------
def test_fig11_table_and_neurons_per_core_equal_the_reference():
    assert tsim.scaling_curve() == jsim.scaling_curve()
    for procs in (10, 480, 10_000):
        assert tsim.scaling_curve(procs) == jsim.scaling_curve(procs)
    for n in (1, 512, 4096, 32_768, 100_000, 500_000, 10 ** 7):
        assert tsim.max_neurons_per_core(n) == jsim.max_neurons_per_core(n)


@pytest.fixture(scope="module")
def reference_run():
    """The reference's draws and its states of ``neuron_sim.simulate``
    (N=512, 200 steps, seed 0), as numpy: the reference's step body run
    in a scan that also returns the states.  Its spike total equals
    ``simulate``'s, so these states are the reference's."""
    key = jax.random.PRNGKey(SEED)
    k1, k2, k3 = jax.random.split(key, 3)
    r = jax.random.uniform(k1, (N,))
    exc = jax.random.uniform(k2, (N,)) < 0.8
    W = jax.random.uniform(k3, (N, N)) < 0.10
    keys = jax.random.split(key, STEPS)
    a = jnp.where(exc, 0.02, 0.02 + 0.08 * r)
    b = jnp.where(exc, 0.2, 0.25 - 0.05 * r)
    c = jnp.where(exc, -65.0 + 15 * r ** 2, -65.0)
    d = jnp.where(exc, 8.0 - 6 * r ** 2, 2.0)
    Wv = jnp.where(W, jnp.where(exc[None, :], 0.5, -1.0), 0.0)

    def step(state, key):
        v, u = state
        I = 5.0 * jax.random.normal(key, (N,))
        fired = v >= 30.0
        I = I + Wv @ fired.astype(jnp.float32)
        v = jnp.where(fired, c, v)
        u = jnp.where(fired, u + d, u)
        v = v + 1.0 * (0.04 * v * v + 5.0 * v + 140.0 - u + I)
        v = jnp.minimum(v, 30.0)
        u = u + 1.0 * a * (b * v - u)
        return (v, u), (fired.sum(), v, u)

    v0 = jnp.full((N,), -65.0)
    _, (spikes, vs, us) = jax.lax.scan(step, (v0, b * v0), keys)
    total = jsim.simulate(N, STEPS, SEED)["total_spikes"]
    assert int(spikes.sum()) == total
    noise = jax.vmap(lambda k: jax.random.normal(k, (N,)))(keys)
    np_ = lambda x: np.array(x)         # noqa: E731
    return dict(r=np_(r), exc=np_(exc), W=np_(W), noise=np_(noise),
                params=[np_(x) for x in (a, b, c, d)], Wv=np_(Wv),
                v=np.concatenate([np_(v0)[None], np_(vs)]),
                u=np.concatenate([np_(b * v0)[None], np_(us)]),
                total=total)


def _port_network(ref):
    params = tsim.neuron_params(torch.from_numpy(ref["r"]),
                                torch.from_numpy(ref["exc"]))
    Wv = tsim.connection_table(torch.from_numpy(ref["W"]),
                               torch.from_numpy(ref["exc"]))
    return params, Wv


def test_parameters_and_table_equal_the_reference_on_its_draws(
        reference_run):
    params, Wv = _port_network(reference_run)
    for got, want in zip(params, reference_run["params"]):
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(Wv.numpy(), reference_run["Wv"])
    v0, u0 = tsim.initial_state(params)
    assert np.array_equal(v0.numpy(), reference_run["v"][0])
    assert np.array_equal(u0.numpy(), reference_run["u"][0])


def test_one_step_parity_from_every_reference_state(reference_run):
    ref = reference_run
    params, Wv = _port_network(ref)
    a, b, c, d = (x.numpy() for x in params)
    worst = 0.0
    for t in range(STEPS):
        v, u = ref["v"][t], ref["u"][t]
        noise = ref["noise"][t]
        (v1, u1), fired = tsim.step((torch.from_numpy(v),
                                     torch.from_numpy(u)),
                                    torch.from_numpy(noise), Wv, params)
        assert np.array_equal(fired.numpy(), v >= 30.0), t
        assert np.array_equal(v1.numpy() >= 30.0, ref["v"][t + 1] >= 30.0), t
        # the update's largest term, after the reset of the fired neurons
        vr = np.where(v >= 30.0, c, v)
        ur = np.where(v >= 30.0, u + d, u)
        I = 5.0 * noise + ref["Wv"] @ (v >= 30.0).astype(np.float32)
        scale = np.max([0.04 * vr * vr, np.abs(5.0 * vr),
                        np.full_like(vr, 140.0), np.abs(ur), np.abs(I)], 0)
        unit = np.finfo(np.float32).eps * scale
        for got, want in ((v1.numpy(), ref["v"][t + 1]),
                          (u1.numpy(), ref["u"][t + 1])):
            units = np.abs(got.astype(np.float64) - want) / unit
            worst = max(worst, float(units.max()))
            assert units.max() <= ULPS, (t, float(units.max()))
    assert worst > 0          # the two do round differently


def test_totals_on_the_reference_draws_within_tolerance(reference_run):
    """781 spikes against the reference's 785 (N=512, 200 steps, seed 0):
    the rounding differences of the one-step test, amplified by the
    threshold dynamics."""
    ref = reference_run
    params, Wv = _port_network(ref)
    state = tsim.initial_state(params)
    total = 0
    for t in range(STEPS):
        state, fired = tsim.step(state, torch.from_numpy(ref["noise"][t]),
                                 Wv, params)
        total += int(fired.sum())
    assert ref["total"] == 785 and total == 781
    assert abs(total - ref["total"]) <= TOTAL_TOL * ref["total"]


def test_simulate_is_seeded_and_keeps_the_steps_asked_for():
    a = tsim.simulate(128, 50, seed=3, device="cpu", keep=(0, 49))
    b = tsim.simulate(128, 50, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    assert a["total_spikes"] == b["total_spikes"]
    assert sorted(a["kept"]) == [0, 49]
    (v, u), noise = a["kept"][0]
    assert torch.equal(v, torch.full((128,), -65.0)) and noise.shape == (128,)
    # the kept input of step 49 leads to the run's last step
    (v, u), noise = a["kept"][49]
    _, fired = tsim.step((v, u), noise, a["Wv"], a["params"])
    assert fired.dtype == torch.bool


def test_neuron_sim_script_prints_the_reference_tables():
    port = _run_script("torch_neuron_sim.py", "--device", "cpu")
    assert port.returncode == 0, port.stderr[-2000:]
    ref = run_example("neuron_sim.py")
    assert ref.returncode == 0, ref.stderr[-2000:]
    p_lines, r_lines = port.stdout.splitlines(), ref.stdout.splitlines()
    assert p_lines[0].startswith("simulated 512 neurons x 200 ms: ")
    assert p_lines[1:] == r_lines[1:]       # Fig. 11 and the N=100k line


# --- batched serving -------------------------------------------------------
def test_serve_batch_script_prints_the_reference_line():
    port = _run_script("torch_serve_batch.py", "--device", "cpu", "--mesh",
                       "1x2")
    assert port.returncode == 0, port.stderr[-2000:]
    ref = run_example("serve_batch.py")
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert port.stdout.split(" in ")[0] == ref.stdout.split(" in ")[0] \
        == "served 12 requests x 16 tokens"
    assert "on a 1x2 mesh" in port.stdout


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_serve_batch_on_a_mesh_serves_the_one_device_tokens(mesh):
    one = tserve.main(["--device", "cpu", "--fp32"])
    got = tserve.main(["--device", "cpu", "--fp32", "--mesh", mesh])
    assert len(one) == 12 and all(len(t) == 16 for t in one)
    assert got == one


# --- §X-B ------------------------------------------------------------------
def _untimed(text):
    return [ln for ln in text.splitlines() if "M reads/s" not in ln]


def test_shared_memory_script_prints_the_reference_lines():
    port = _run_script("torch_shared_memory.py", "--device", "cpu")
    assert port.returncode == 0, port.stderr[-2000:]
    ref = run_example("shared_memory.py")
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert _untimed(port.stdout) == _untimed(ref.stdout)
    assert sum("M reads/s (cpu)" in ln
               for ln in port.stdout.splitlines()) == 2


def test_prefix_sharing_on_reference_params_matches_the_reference():
    cfg, params = get_tiny_model()
    cfg = cfg.replace(activation_dtype="float32")
    tcfg = get_tiny_config("tiny-100m").replace(activation_dtype="float32")
    tparams = from_reference(jax.tree.map(np.asarray, params), tcfg, "cpu")
    S, gen, ps, shared = 14, 4, 4, 10
    prompts = tshm.shared_prompts(cfg.vocab_size, 3, S, shared)
    port = tshm.serve_shared(tcfg, tparams, prompts, gen, page_size=ps,
                             n_pages=32, device="cpu")
    for (eng, toks), prefix_cache in zip(port, (False, True)):
        ref = JEngine(cfg, params, max_batch=3, page_size=ps, n_pages=32,
                      max_len=S + gen, prefix_cache=prefix_cache)
        for i, p in enumerate(prompts):
            ref.submit(p, gen, rid=f"r{i}")
        want = {r.rid: list(r.tokens) for r in ref.run()}
        assert toks == want
        got, exp = eng.metrics(), ref.metrics()
        for k in ("prefill_tokens", "prefix_hit_rate", "cow_copies",
                  "shared_pages", "bytes_deduped", "tokens_out"):
            assert got.get(k) == exp.get(k), (prefix_cache, k)
    assert port[0][1] == port[1][1]
    assert port[1][0].metrics()["cow_copies"] > 0
