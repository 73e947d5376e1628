"""The port's serving path (prefill, decode_step, ServeLoop) against the JAX
package's, on the CPU: the ssm and hybrid families, chunked prefill (GQA
and MLA), the split SSM projections, and ServeLoop on dense, MLA + MoE and
vlm models (the vlm's decode positions start after its patches).

Weights are JAX's, carried across with `repro_torch.convert`; inputs come
from numpy seeds.  Tolerances: `train_loss` rtol 1e-5 (as the dense slice's
test); prefill logits and caches and each teacher-forced decode step's
logits atol 3e-4, the tolerance of tests/test_decode_consistency.py.  With
the kernel flags on, JAX runs its Pallas kernels in interpret mode and the
port its plain versions (CPU tensors).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.models import model as jm
from repro.serve import serving as jserving
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.models.config import ModelConfig
from repro_torch.serve import ServeLoop, component_mean_params

from _torch_parity import to_np
from test_decode_consistency import CONFIGS as DECODE_CONFIGS

ATOL = 3e-4

# (architecture, config changes): zamba2-smoke is one group; three layers
# give two groups (shared_block + 2 mamba, then shared_block + 1 mamba)
KERNELS = {"use_flash": True, "use_ssd_kernel": True}
CASES = {
    "zamba2": ("zamba2-1.2b", {}),
    "zamba2-two-groups-kernels": ("zamba2-1.2b", {"n_layers": 3, **KERNELS}),
    "mamba2-kernel": ("mamba2-1.3b", {"use_ssd_kernel": True}),
    # the 21-token prefill in query chunks of 7 (GQA's and MLA's chunked
    # routes); the split SSM projections
    "qwen3-chunked": ("qwen3-14b", {"prefill_chunk": 7}),
    "deepseek-lite-chunked": ("deepseek-v2-lite-16b", {"prefill_chunk": 7}),
    "mamba2-split-proj": ("mamba2-1.3b", {"ssm_split_proj": True}),
}


def _configs(case):
    arch, kw = CASES[case]
    return jget_config(arch, "smoke").replace(**kw), get_config(arch, "smoke").replace(**kw)


def _leaves_close(got_tree, want_tree, atol, msg):
    got, want = convert.flatten(got_tree), jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want), msg
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape, msg
        np.testing.assert_allclose(to_np(g), np.asarray(w, np.float32), atol=atol, err_msg=msg)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case):
    cj, ct = _configs(case)
    pj = jm.init_params(jax.random.PRNGKey(1), cj)
    pt = convert.to_torch(jax.device_get(pj))
    tok = np.random.default_rng(2).integers(0, cj.vocab, (2, 24)).astype(np.int32)
    cap, half = 24, 21

    lj = float(jm.train_loss(pj, cj, {"tokens": jnp.asarray(tok)}))
    with torch.no_grad():
        lt = float(tm.train_loss(pt, ct, {"tokens": torch.as_tensor(tok)}))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)

    lg_j, c_j = jm.prefill(pj, cj, {"tokens": jnp.asarray(tok[:, :half])}, cap)
    lg_t, c_t = tm.prefill(pt, ct, {"tokens": torch.as_tensor(tok[:, :half])}, cap)
    assert lg_t.dtype == torch.float32
    np.testing.assert_allclose(to_np(lg_t), np.asarray(lg_j), atol=ATOL)
    _leaves_close(c_t, c_j, ATOL, "prefill caches")
    for t in range(half, 24):
        lg_j, c_j = jm.decode_step(pj, cj, jnp.asarray(tok[:, t]), jnp.int32(t), c_j)
        lg_t, c_t = tm.decode_step(pt, ct, torch.as_tensor(tok[:, t]), t, c_t)
        np.testing.assert_allclose(to_np(lg_t), np.asarray(lg_j), atol=ATOL, err_msg=f"step {t}")
    _leaves_close(c_t, c_j, ATOL, "decoded caches")


def test_init_cache_tree_matches_prefill():
    _, ct = _configs("zamba2-two-groups-kernels")
    params = tm.init_params(0, ct, device="cpu")
    empty = tm.init_cache(ct, 2, 16, device="cpu")
    _, filled = tm.prefill(params, ct, {"tokens": torch.zeros(2, 5, dtype=torch.int32)}, 16)
    assert [tuple(x.shape) for x in convert.flatten(empty)] == \
           [tuple(x.shape) for x in convert.flatten(filled)]
    jc = jm.init_cache(jget_config("zamba2-1.2b", "smoke").replace(n_layers=3), 2, 16)
    assert [tuple(x.shape) for x in convert.flatten(empty)] == \
           [x.shape for x in jax.tree_util.tree_leaves(jc)]


def _port_cfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


@pytest.mark.parametrize("name", ["dense", "window", "ssm", "hybrid"])
def test_decode_matches_own_full_forward(name):
    """The port's prefill + token-by-token decode reproduce its own
    full-sequence logits (the configs of tests/test_decode_consistency.py)."""
    cfg = _port_cfg(DECODE_CONFIGS[name])
    b, s = 2, 16
    params = tm.init_params(1, cfg, device="cpu")
    tok = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (b, s)))
    with torch.no_grad():
        x = params["embed"][tok]
        xf, _, _ = tm._run_trunk_full(params, cfg, x, torch.arange(s), False, s)
        full = tm._logits(params, cfg, xf)
        half = s // 2
        lg, caches = tm.prefill(params, cfg, {"tokens": tok[:, :half]}, s)
        errs = [(lg - full[:, half - 1]).abs().max().item()]
        for t in range(half, s):
            lg, caches = tm.decode_step(params, cfg, tok[:, t], t, caches)
            errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < ATOL, (name, errs)


def test_ring_buffer_wraparound_matches_windowed_attention():
    cfg = _port_cfg(DECODE_CONFIGS["window"])  # window = 8
    b, s, cap = 1, 24, 8                        # capacity == window
    params = tm.init_params(0, cfg, device="cpu")
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (b, s)))
    with torch.no_grad():
        xf, _, _ = tm._run_trunk_full(params, cfg, params["embed"][tok], torch.arange(s), False,
                                      s)
        full = tm._logits(params, cfg, xf)
        lg, caches = tm.prefill(params, cfg, {"tokens": tok[:, :4]}, cap)
        errs = []
        for t in range(4, s):
            lg, caches = tm.decode_step(params, cfg, tok[:, t], t, caches)
            errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < ATOL, errs


def _stacked_jax_params(cfg, m, seed):
    trees = [jm.init_params(jax.random.PRNGKey(seed + i), cfg) for i in range(m)]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "stablelm-1.6b", "internvl2-2b",
                                  "deepseek-v2-lite-16b"])
def test_serve_loop_matches_jax(arch):
    cj, ct = jget_config(arch, "smoke"), get_config(arch, "smoke")
    pj = _stacked_jax_params(cj, 2, 5)
    pt = convert.to_torch(jax.device_get(pj))
    kw = dict(prompt_len=12, gen=5, batch=2, seed=3)
    # the same prompt stream, bit for bit
    jb, tb = jserving.ServeLoop(cj, **kw).make_batch(), ServeLoop(ct, device="cpu", **kw).make_batch()
    assert tb["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(to_np(tb["tokens"]), np.asarray(jb["tokens"]))
    assert sorted(tb) == sorted(jb)  # a vlm's zero patch embeddings too
    jloop, tloop = jserving.ServeLoop(cj, **kw), ServeLoop(ct, device="cpu", **kw)
    assert (tloop.offset, tloop.capacity) == (jloop.offset, jloop.capacity)
    for policy in ("local", "consensus"):
        want = jloop.serve_round(pj, policy=policy)
        got = tloop.serve_round(pt, policy=policy)
        assert sorted(got) == sorted(want) == [0, 1]
        for i in got:
            assert got[i]["tokens"].shape == (2, 5)
            np.testing.assert_array_equal(got[i]["tokens"], want[i]["tokens"], err_msg=policy)
            assert got[i]["prefill_ms"] > 0 and got[i]["tokens_per_s"] > 0


@pytest.mark.parametrize("comp", [None, [0, 1, 0, 2]])
def test_component_mean_params_matches_jax(comp):
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((4, 3, 5)).astype(np.float32),
            "b": [rng.standard_normal(4).astype(np.float32)],
            "c": jnp.asarray(rng.standard_normal((4, 7)), jnp.bfloat16)}
    want = jserving.component_mean_params(jax.tree_util.tree_map(jnp.asarray, tree), comp)
    got = component_mean_params(convert.to_torch(jax.device_get(tree)), comp)
    assert got["c"].dtype == torch.bfloat16
    _leaves_close(got, want, 1e-6, f"comp={comp}")


def test_serve_loop_rejects_bad_arguments():
    cfg = get_config("zamba2-1.2b", "smoke")
    with pytest.raises(ValueError, match="gen"):
        ServeLoop(cfg, gen=1, device="cpu")
    with pytest.raises(ValueError, match="policy"):
        ServeLoop(cfg, device="cpu").serve_round({}, policy="nearest")
