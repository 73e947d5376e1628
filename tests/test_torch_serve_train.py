"""Serve-while-train in the port (`repro_torch.launch.serve_train`) against
the JAX package (`tests/test_chaos.py`'s serve_train cases and more).

On the same argv the port's event log equals JAX's: the node count after
each event, the donors, the catch-up source (a checkpoint), the conformance
flags and the partition's component ids.  The event clocks draw from
different generators, so losses and queues are not compared; an empty
``--chaos`` runs the plain path bit for bit (port against port).

The leave check at bf16: JAX's check holds the survivors' mean to atol
1e-5·max(|mean|, 1) whatever the type, and JAX's own `retire_state` on a
bf16 stack of 5 x 4096 values near 0.02 misses it (each survivor's new
row is stored once in bf16).  The port's check adds half a bf16 ulp of
the leaf's largest magnitude for bf16 leaves: it passes on the same stack
and still catches a handoff with β dropped, at bf16 and at f32.  The
parameter means and the heal's drift are held against JAX's host versions
at rtol 1e-5.  `test_chip_smoke_path_g_rehearsal` runs the chip smoke's
path G at a tiny size on the CPU.
"""
import importlib.util
import os
import re
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.topology import build_topology as jbuild
from repro.launch import serve_train as jsv
from repro.serve import membership as jmb
from repro_torch.configs import get_config
from repro_torch.core.mixing import _gather_terms_slots
from repro_torch.core.topology import build_topology
from repro_torch.launch import serve_train as sv
from repro_torch.serve import membership as mb
from repro_torch.tree import tree_leaves

from _torch_parity import one_torch_thread, to_t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SERVE_ARGS = ["--arch", "stablelm-1.6b", "--variant", "smoke", "--layers", "1", "--steps", "4",
              "--batch", "1", "--seq", "16", "--nodes", "4", "--chunk", "2", "--arrival", "quiet",
              "--prompt-len", "4", "--gen", "2", "--serve-batch", "1", "--serve-nodes", "1",
              "--device", "cpu"]


def test_empty_chaos_timeline_bitwise_pin(capsys):
    """`--chaos ""` leaves every code path of the plain run untouched: the
    final states are bitwise equal leaf by leaf."""
    plain, rec_plain = sv.main(SERVE_ARGS)
    empty, rec_empty = sv.main(SERVE_ARGS + ["--chaos", ""])
    capsys.readouterr()
    for a, b in zip(tree_leaves(plain), tree_leaves(empty)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    assert rec_plain["losses"] == rec_empty["losses"] and not rec_empty["events"]


def test_serve_train_chaos_smoke(capsys):
    """Every event kind (leave, partition, heal) with consensus serving:
    the monitors and the leave's conformance come back green, and the
    record holds each event, serve round and the serving summary."""
    _, rec = sv.main(["--arch", "stablelm-1.6b", "--variant", "smoke", "--layers", "1",
                      "--steps", "8",
                      "--batch", "1", "--seq", "16", "--nodes", "5", "--chunk", "2",
                      "--arrival", "quiet", "--prompt-len", "4", "--gen", "2",
                      "--serve-batch", "1", "--serve-nodes", "1", "--serve-policy", "consensus",
                      "--chaos", "leave@2:1,partition@4:bridge,heal@6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "leave@2: m=5->4" in out
    assert "partition@4: graph split into 2 components" in out
    assert "heal@6: partition re-merged" in out
    assert out.count("(green)") >= 3 and "[serve-train] done" in out
    assert [(e["kind"], e["m_after"]) for e in rec["events"]] == [
        ("leave", 4), ("partition", 4), ("heal", 4)]
    assert rec["events"][1]["monitor"]["cross_mass"] == 0.0
    assert rec["events"][0]["leave_check"]["drift"] <= rec["events"][0]["leave_check"]["tol"]
    assert len(rec["losses"]) == 8 and np.all(np.isfinite(rec["losses"]))
    for r in rec["serves"]:
        for st in r["nodes"].values():
            assert st["tokens"] == (1, 2) and st["logits_finite"]
    assert rec["summary"]["served"] <= rec["summary"]["arrived"]


# ---------------------------------------------------------------------------
# the CLI's event log against JAX's
# ---------------------------------------------------------------------------
LOG_ARGS = ["--arch", "stablelm-1.6b", "--variant", "smoke", "--steps", "6", "--batch", "1",
            "--seq", "16", "--nodes", "4", "--chunk", "2", "--arrival", "quiet",
            "--prompt-len", "4", "--gen", "2", "--serve-batch", "1", "--serve-nodes", "1",
            "--chaos", "join@2:1,partition@3:2,heal@4,leave@5:1", "--ckpt-every", "2"]
JOIN_RE = re.compile(r"join@(\d+): m=(\d+)->(\d+) donors=(\[[^\]]*\]) catch-up=(\S+) "
                     r"conformance: doubly-stochastic=(\w+) mean-preserving=(\w+)")
LEAVE_RE = re.compile(r"leave@(\d+): m=(\d+)->(\d+) retired=(\[[^\]]*\]) .* "
                      r"doubly-stochastic=(\w+) mean-preserving=(\w+)")


def _events(log):
    return JOIN_RE.findall(log), LEAVE_RE.findall(log), log.count("(green)")


def test_event_log_matches_jax(tmp_path, monkeypatch, capsys):
    comps = {}

    def monitor(bound, k, tag, _real=jsv._chaos_monitor):
        comps[tag] = jsv._active_comp(bound, k)
        return _real(bound, k, tag)

    monkeypatch.setattr(jsv, "_chaos_monitor", monitor)
    jsv.main(LOG_ARGS + ["--ckpt-dir", str(tmp_path / "jax")])
    jlog = capsys.readouterr().out
    _, rec = sv.main(LOG_ARGS + ["--ckpt-dir", str(tmp_path / "torch"), "--device", "cpu"])
    tlog = capsys.readouterr().out
    assert _events(tlog) == _events(jlog)
    joins, leaves, _ = _events(tlog)
    assert joins == [("2", "4", "5", "[1]", "ckpt@2", "True", "True")]
    assert leaves == [("5", "5", "4", "[4]", "True", "True")]
    by_kind = {e["kind"]: e for e in rec["events"]}
    assert by_kind["join"]["catch_up"] == "ckpt@2" and by_kind["join"]["donors"] == [1]
    assert [e["m_after"] for e in rec["events"]] == [5, 5, 5, 4]
    np.testing.assert_array_equal(by_kind["partition"]["comp"], comps["partition@3"])
    assert comps["partition@3"].max() == 1


# ---------------------------------------------------------------------------
# the leave check at the leaf's type
# ---------------------------------------------------------------------------
def _bound():
    """What the checks read of a bound algorithm: the state is the params."""
    return types.SimpleNamespace(spec=types.SimpleNamespace(params_of=lambda s: s),
                                 params_of=lambda s: s)


def _stack(jdtype):
    rng = np.random.default_rng(0)
    return {"p": jnp.asarray(0.02 * rng.standard_normal((5, 4096)), jdtype)}


def test_leave_check_at_bf16_jax_raises_port_passes():
    """JAX's retire_state and check on a bf16 stack: the check raises (its
    f32 tolerance is below a bf16 store's rounding).  The port's
    retire_state, bitwise JAX's, passes the port's check; in f32 both pass."""
    topo_j, topo_t = jbuild("erdos_renyi", 5, p=0.5, seed=0), build_topology(
        "erdos_renyi", 5, p=0.5, seed=0)
    for jdtype, jax_passes in ((jnp.bfloat16, False), (jnp.float32, True)):
        tree = _stack(jdtype)
        pre = jsv._params_mean(_bound(), tree)
        jout = jmb.retire_state(tree, topo_j, (4,))
        if jax_passes:
            jsv._leave_conformance(pre, _bound(), jout, 5, 4)
        else:
            with pytest.raises(AssertionError, match="leave conformance FAILED"):
                jsv._leave_conformance(pre, _bound(), jout, 5, 4)
        ttree = {"p": to_t(tree["p"])}
        tpre = sv._params_mean(_bound(), ttree)
        np.testing.assert_array_equal(tpre[0].numpy(), pre)
        tout = mb.retire_state(ttree, topo_t, (4,))
        np.testing.assert_array_equal(tout["p"].float().numpy(),
                                      np.asarray(jout["p"], np.float32))
        check = sv._leave_conformance(tpre, _bound(), tout, 5, 4)
        assert check["drift"] <= check["tol"]


@pytest.mark.parametrize("jdtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "f32"])
def test_leave_check_catches_dropped_handoff(jdtype):
    """A departure that drops the leaver's row without the β handoff loses
    mass: the port's check raises at bf16 and at f32."""
    ttree = {"p": to_t(_stack(jdtype)["p"])}
    pre = sv._params_mean(_bound(), ttree)
    with pytest.raises(AssertionError, match="leave conformance FAILED"):
        sv._leave_conformance(pre, _bound(), {"p": ttree["p"][:4].clone()}, 5, 4)


def test_params_mean_and_comp_drift_match_jax(monkeypatch):
    """The port's means (on the device, a leaf and a block of columns at a
    time, blocks of 4 columns here) against JAX's host copies: the global
    mean bit for bit, the heal's component drift at rtol 1e-5."""
    rng = np.random.default_rng(5)
    tree = {"a": jnp.asarray(rng.standard_normal((5, 3, 7)), jnp.bfloat16),
            "b": [jnp.asarray(rng.standard_normal((5, 11)), jnp.float32)]}
    ttree = {"a": to_t(tree["a"]), "b": [to_t(tree["b"][0])]}
    monkeypatch.setattr(mb, "BLOCK_COLS", 4)
    monkeypatch.setattr(sv.scen_mod, "STATS_COLS", 4)
    got = np.concatenate([x.numpy() for x in sv._params_mean(_bound(), ttree)])
    np.testing.assert_array_equal(got, jsv._params_mean(_bound(), tree))
    comp = np.asarray([0, 1, 1, 0, 1])
    np.testing.assert_allclose(sv._comp_drift(_bound(), ttree, comp),
                               jsv._comp_drift(_bound(), tree, comp), rtol=1e-5)


def test_serve_train_refusals(monkeypatch):
    """Membership changes with crashes, and a CUDA run without a card, are
    refused (--compile-cache, once refused here, runs:
    test_torch_model.py::test_unported_surfaces_raise)."""
    with pytest.raises(ValueError, match="crash"):
        sv.main(SERVE_ARGS + ["--join", "2:1", "--crash", "0.1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sv.main([a for a in SERVE_ARGS if a not in ("--device", "cpu")])


def test_serve_decode_example_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable, os.path.join(REPO, "examples", "serve_decode_torch.py"),
           "--device", "cpu", "--prompt-len", "12", "--gen", "6", "--batch", "2"]
    for extra in ([], ["--window", "8"]):
        proc = subprocess.run(cmd + extra, capture_output=True, text=True, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert "[serve] decode 5 steps" in proc.stdout and "generated ids" in proc.stdout
    proc = subprocess.run(cmd[:2], capture_output=True, text=True, env=env, timeout=300,
                          cwd=REPO)
    if not torch.cuda.is_available():
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr


# ---------------------------------------------------------------------------
# the chip smoke's path G, rehearsed at a tiny size
# ---------------------------------------------------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny(argv, **values):
    out = list(argv)
    for flag, value in values.items():
        out[out.index("--" + flag.replace("_", "-")) + 1] = value
    return out


def test_chip_smoke_path_g_rehearsal(monkeypatch, capsys):
    """`chip_smoke.py`'s path G on the CPU: G1 on the smoke model (m = 4 -> 5
    -> 4, deferrals, green monitors, finite serving), G2 (catch-up from the
    step-4 checkpoint, the joiner's rows the donor's checkpointed rows, the
    trainer resuming at step 4), and parity phase G (PaME's paced step on
    the 4-node graph and on G1's grown 5-node one) with the kernel route
    forced and its CPU stand-in replaced by the CUDA kernel's arithmetic
    (f32 slots chain, rounded once): 0 ulps, one deferred node, and the
    membership calls equal on both sides."""
    from repro_torch.kernels.gossip import ops as gops

    cs = _chip_smoke()
    cpu = torch.device("cpu")
    small = dict(variant="smoke", batch="1", seq="16", prompt_len="8", gen="4", serve_batch="2")
    cs.path_g1(cpu, argv=_tiny(cs.G1_ARGS, **small) + ["--layers", "1"])
    cs.path_g2(cpu, argv=_tiny(cs.G2_ARGS, layers="1", **small),
               train_argv=_tiny(cs.G2_TRAIN, variant="smoke", batch="1", seq="16", layers="1"))
    out = capsys.readouterr().out
    assert '"phase": "path_g1"' in out and '"catch_up": "ckpt@4"' in out
    assert '"joiner_equals_ckpt_donor": true' in out and '"train_start": 4' in out

    monkeypatch.setenv("REPRO_TORCH_GOSSIP_IMPL", "kernel")

    def kernel_arithmetic(nbrs, terms, pad=None):
        clean = [(w if pad is None else torch.where(pad, torch.zeros_like(w), w), x.float())
                 for w, x in terms]
        return tuple(o.to(x.dtype) for o, (_, x) in zip(_gather_terms_slots(nbrs, clean), terms))

    monkeypatch.setattr(gops, "gather_terms_ref", kernel_arithmetic)
    cfg = get_config("stablelm-1.6b", "smoke").replace(dtype="bfloat16", n_layers=1)
    rows = cs.path_g_parity(cpu, cfg=cfg, batch=1, seq=8)
    for key in ("pame-paced", "pame-paced-grown", "dpsgd-paced"):
        assert rows[key]["max_bf16_ulps_floored"] == 0.0 and rows[key]["f32_bit_equal"]
        assert rows[key]["deferred_nodes"] == 1
    assert rows["pame-paced-grown"]["m"] == 5
    assert rows["membership"]["retire_max_bf16_ulps_floored"] == 0.0
    assert rows["membership"]["expand_max_bf16_ulps_floored"] == 0.0
    assert '"phase": "parity_g"' in capsys.readouterr().out


def test_runner_donates_the_callers_state():
    """A state handed over in an `engine.Donated` box is given up as JAX's
    donation does: the first input's tensors that the outputs do not hold
    are gone by the second step, so a chunk of 3 steps holds one state, not
    two; the results equal a copy_state=True run, which leaves the caller's
    state intact; a tensor the step updates in place lives on in the
    output; a box is taken once."""
    import weakref

    from repro_torch.core import engine

    first, alive = {}, []

    def step(state, batch):
        if first:
            alive.append(first["w"]() is not None)
        new = {"w": state["w"] * 0.5 + batch, "kept": state["kept"].add_(1.0)}
        return new, {"loss_mean": new["w"].sum()}

    def fresh():
        return {"w": torch.arange(6.0), "kept": torch.zeros(3)}

    run = engine.make_scan_runner(step, chunk_size=3)
    ref_in = fresh()
    ref, ref_m, _ = run(ref_in, lambda k: torch.ones(6), 3)
    assert torch.equal(ref_in["w"], torch.arange(6.0))
    given = fresh()
    first["w"], kept = weakref.ref(given["w"]), given["kept"]
    box, given = engine.Donated(given), None
    out, m, _ = run(box, lambda k: torch.ones(6), 3)
    assert alive == [True, False, False]
    assert out["kept"] is kept
    assert torch.equal(out["w"], ref["w"]) and torch.equal(out["kept"], ref["kept"])
    np.testing.assert_array_equal(m["loss_mean"], ref_m["loss_mean"])
    with pytest.raises(ValueError, match="taken once"):
        run(box, lambda k: torch.ones(6), 1)


def test_runner_keeps_storage_held_outside_the_state():
    """Donation frees nothing that is held elsewhere: a state leaf that is a
    view of a tensor the caller keeps (a single-node stack of shared
    weights), and a leaf with a view of it kept elsewhere, keep their
    values through a donated run, whose results equal a copy_state=True
    run."""
    from repro_torch.core import engine

    def step(state, batch):
        new = {k: v * 0.5 + batch for k, v in state.items()}
        return new, {"loss_mean": sum(v.sum() for v in new.values())}

    run = engine.make_scan_runner(step, chunk_size=3)
    params0 = torch.arange(4.0)
    given = {"stacked": params0.unsqueeze(0), "viewed": torch.arange(5.0), "own": torch.ones(3)}
    outside = given["viewed"][1:]
    ref, ref_m, _ = run({k: v.clone() for k, v in given.items()}, lambda k: 1.0, 3)
    box, given = engine.Donated(given), None
    out, m, _ = run(box, lambda k: 1.0, 3)
    assert torch.equal(params0, torch.arange(4.0))
    assert torch.equal(outside, torch.arange(1.0, 5.0))
    for k in ref:
        assert torch.equal(out[k], ref[k])
    np.testing.assert_array_equal(m["loss_mean"], ref_m["loss_mean"])
