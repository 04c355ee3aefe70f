"""The port's serving path against the JAX package's.

For the smoke configurations of the four dense architectures, the two MoE
architectures (deepseek-moe-16b, arctic-480b), rwkv6, zamba2, the audio
encoder hubert-xlarge and the image-prefix LM paligemma-3b, the
reference's ``init_params`` weights are carried into the port
through ``interop.lm_params_from_state``, and both packages run on them:
layers, ``forward`` (hubert on frame features under a frame mask,
paligemma behind an image prefix), teacher-forced ``decode_step`` (both
fed the same tokens, so an argmax flip cannot cascade; hubert has none),
``prefill_fn`` and greedy decoding, and ``lm_loss`` (hubert's masked
prediction among them).  f32 is held to 2e-3 and bf16 to 5e-2, the
tolerances of ``tests/test_kernels.py``.
All of it runs on the CPU, where attention is the plain version.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.launch.serve import greedy_generate as ref_greedy_generate
from repro.models import layers as ref_layers
from repro.models.common import init_params as ref_init_params
from repro.models.common import param_bytes as ref_param_bytes
from repro.models.lm import decode_step as ref_decode_step
from repro.models.lm import forward as ref_forward
from repro.models.lm import init_cache as ref_init_cache
from repro.models.lm import layer_windows as ref_layer_windows
from repro.models.lm import lm_loss as ref_lm_loss
from repro.serve.serve_step import prefill_fn as ref_prefill_fn
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.interop import lm_params_from_state
from repro_torch.launch.serve import greedy_generate, main
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig, init_params, param_bytes
from repro_torch.models.lm import (decode_step, forward, init_cache,
                                   layer_windows, lm_loss)
from repro_torch.serve.serve_step import decode_fn, prefill_fn

#: the architectures that decode, and hubert, which only encodes
DECODE_ARCHS = ["qwen3-8b", "h2o-danube-1.8b", "h2o-danube-3-4b",
                "gemma3-27b", "deepseek-moe-16b", "arctic-480b", "rwkv6-1.6b",
                "zamba2-2.7b", "paligemma-3b"]
ARCH_NAMES = DECODE_ARCHS + ["hubert-xlarge"]
#: one architecture of each family
FAMILY_ARCHS = {"dense": "qwen3-8b", "moe": "deepseek-moe-16b",
                "rwkv6": "rwkv6-1.6b", "zamba2": "zamba2-2.7b",
                "hubert": "hubert-xlarge", "paligemma": "paligemma-3b"}
#: name -> (jax dtype, torch dtype, tolerance)
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _np(t):
    return t.float().numpy()


def _jax(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


@functools.lru_cache(maxsize=None)
def _models(arch, dt, seed=0):
    """(reference cfg, reference params, port cfg, port params) on the same
    weights."""
    jdt, tdt, _ = DTYPES[dt]
    rcfg = ref_smoke_config(arch).scaled(dtype=jdt)
    pcfg = smoke_config(arch).scaled(dtype=tdt)
    rparams = ref_init_params(jax.random.PRNGKey(seed), rcfg)
    pparams = lm_params_from_state(jax.tree.map(np.asarray, rparams), pcfg,
                                   "cpu")
    return rcfg, rparams, pcfg, pparams


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _inputs(cfg, B, S, seed=0):
    """A model's inputs as numpy arrays, as the reference's
    ``tests/test_arch_smoke.py`` makes them: tokens, and paligemma's image
    embeddings (B, n_prefix_tokens, d); or hubert's frame features
    (B, S, d) and frame mask (B, S)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "hubert":
        return {"features": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32),
                "feat_mask": rng.random((B, S)) < 0.3}
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "paligemma":
        out["img_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


def _forward_args(inputs, lib):
    """``forward``'s (tokens, keywords) from ``_inputs`` for torch or jax."""
    conv = torch.from_numpy if lib == "torch" else jnp.asarray
    kw = {k: conv(a) for k, a in inputs.items() if k != "tokens"}
    tokens = inputs.get("tokens")
    return (None if tokens is None else conv(tokens)), kw


# ---------------------------------------------------------------------------
# configurations and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_configs_match_the_reference(arch):
    ref, port = ref_get_config(arch), get_config(arch)
    for f in ModelConfig.__dataclass_fields__:
        if f != "dtype":
            assert getattr(port, f) == getattr(ref, f), f
    assert port.dtype == torch.bfloat16
    assert (port.kv_heads, port.hd) == (ref.kv_heads, ref.hd)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    if port.family == "moe":
        assert port.active_param_count() < port.param_count()
    assert layer_windows(port) == np.asarray(ref_layer_windows(ref)).tolist()
    smoke, ref_smoke = smoke_config(arch), ref_smoke_config(arch)
    for f in ModelConfig.__dataclass_fields__:
        if f != "dtype":
            assert getattr(smoke, f) == getattr(ref_smoke, f), f


def test_registry_holds_the_dense_archs():
    """The registry holds every architecture of the reference's (the dense
    ones among them) and refuses a name it does not know."""
    from repro.configs import ARCHS as REF_ARCHS
    assert sorted(ARCHS) == sorted(ARCH_NAMES) == sorted(REF_ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch-7b")


def _same_tree(a, b, path=""):
    """The same nesting, keys, shapes and dtypes."""
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}/{i}")
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, path


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_init_params_shapes_scales_and_bytes(arch):
    rcfg, rparams, pcfg, pparams = _models(arch, "bf16")
    gen = torch.Generator().manual_seed(0)
    params = init_params(gen, pcfg, "cpu")
    # the same tree, shapes and dtypes as the reference's, layer by layer
    assert param_bytes(params) == param_bytes(pparams) == \
        ref_param_bytes(rparams)
    _same_tree(params, pparams)
    d = pcfg.d_model
    assert abs(params["embed"].float().std().item() - 0.02) < 0.002
    lp = params["layers"][0]
    if pcfg.family == "rwkv6":
        w = lp["wr"].float()
    elif pcfg.family == "zamba2":
        w = lp["w_in"].float()
    else:
        w = lp["attn"]["wq"].float()
    assert abs(w.std().item() * d ** 0.5 - 1.0) < 0.1
    assert torch.equal(params["final_norm"], torch.ones(d, dtype=pcfg.dtype))
    if pcfg.family == "zamba2":
        # conv at 0.5, A_log and dt_bias f32 zeros, D ones in cfg.dtype
        assert abs(lp["conv_w"].float().std().item() - 0.5) < 0.05
        for name, value, dtype in (("A_log", 0.0, torch.float32),
                                   ("dt_bias", 0.0, torch.float32),
                                   ("D", 1.0, pcfg.dtype)):
            assert lp[name].dtype == dtype
            assert bool((lp[name] == value).all()), name
    if pcfg.family == "moe":
        # the router in f32 at 0.02, the experts at 1/sqrt(fan_in)
        mp = lp["moe"]
        assert mp["router"].dtype == torch.float32
        assert abs(mp["router"].std().item() - 0.02) < 0.003
        assert abs(mp["we_down"].float().std().item()
                   * pcfg.expert_d_ff ** 0.5 - 1.0) < 0.1
        assert ("ws_gate" in mp) == bool(pcfg.n_shared_experts)
        assert ("dense" in mp) == pcfg.dense_residual
    # the front ends: frontend_proj and img_proj at 1/sqrt(d), mask_embed
    # at 0.02 (64 draws: within 3 standard errors of the std)
    for name in ("frontend_proj", "img_proj"):
        assert (name in params) == (pcfg.frontend == {
            "frontend_proj": "audio", "img_proj": "image"}[name])
        if name in params:
            assert abs(params[name].float().std().item() * d ** 0.5
                       - 1.0) < 0.1
    if pcfg.frontend == "audio":
        assert params["mask_embed"].shape == (d,)
        assert abs(params["mask_embed"].float().std().item() - 0.02) < 0.006
    if pcfg.family == "rwkv6":
        # ww at 0.01, mix and u at 0.5, w_bias -5, norms ones
        assert abs(lp["ww"].float().std().item() - 0.01) < 0.001
        for name in ("mix", "u"):
            assert abs(lp[name].float().std().item() - 0.5) < 0.06, name
        assert bool((lp["w_bias"] == -5.0).all())
        for name in ("ln_x", "norm1", "norm2"):
            assert bool((lp[name] == 1.0).all()), name
    again = init_params(torch.Generator().manual_seed(0), pcfg, "cpu")
    key = {"rwkv6": "ffn_v", "zamba2": "w_out",
           "moe": "moe"}.get(pcfg.family, "mlp")
    torch.testing.assert_close(again["layers"][1][key],
                               params["layers"][1][key], rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "forward",
                                   "lm_params_from_state"])
def test_unknown_family_raises(entry):
    cfg = ModelConfig(name="x", family="no-such-family", n_layers=1,
                      d_model=8, n_heads=2, d_ff=8, vocab=16)
    calls = {
        "init_params": lambda: init_params(torch.Generator(), cfg, "cpu"),
        "init_cache": lambda: init_cache(cfg, 1, 4, device="cpu"),
        "forward": lambda: forward({}, cfg, torch.zeros((1, 2),
                                                        dtype=torch.int32)),
        "lm_params_from_state": lambda: lm_params_from_state({}, cfg, "cpu"),
    }
    with pytest.raises(ValueError, match="unknown family"):
        calls[entry]()


@pytest.mark.parametrize("arch", ["hubert-xlarge", "paligemma-3b"])
def test_lm_params_from_state_carries_the_front_ends(arch):
    """The front end's weights and every layer cross unchanged."""
    _, rparams, pcfg, pparams = _models(arch, "f32")
    names = {"audio": ("frontend_proj", "mask_embed"),
             "image": ("img_proj",)}[pcfg.frontend]
    assert set(pparams) == {"embed", "final_norm", "layers", *names} | (
        set() if pcfg.tie_embeddings else {"lm_head"})
    for name in names:
        np.testing.assert_array_equal(_np(pparams[name]),
                                      np.asarray(rparams[name]))
    for i, lp in enumerate(pparams["layers"]):
        for group in ("attn", "mlp"):
            for w, t in lp[group].items():
                np.testing.assert_array_equal(
                    _np(t), np.asarray(rparams[group][w][i]))


def test_hubert_encodes_but_does_not_decode():
    """hubert is encoder-only, as in the reference: no cache, no decode
    step, and the serving CLI refuses it; its prefill encodes."""
    rcfg, _, pcfg, pparams = _models("hubert-xlarge", "f32")
    with pytest.raises(ValueError, match="encoder-only"):
        init_cache(pcfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="no decode cache"):
        ref_init_cache(rcfg, 1, 4)
    with pytest.raises(ValueError, match="encoder-only"):
        decode_step(pparams, pcfg, {"len": 0}, torch.zeros((1, 1),
                                                           dtype=torch.int32))
    with pytest.raises(SystemExit, match="encoder-only"):
        main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
def test_rms_norm_rope_mlp_match(dt):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 16), np.float32)
    scale = rng.standard_normal(16, np.float32) * 0.1
    pos = np.arange(6)[None, :] + 3
    xt = torch.from_numpy(x).to(tdt)
    _close(_np(layers.rms_norm(xt, torch.from_numpy(scale).to(tdt))),
           ref_layers.rms_norm(_jax(x, jdt), _jax(scale, jdt)), tol)
    _close(_np(layers.rope(xt, torch.from_numpy(pos), 1e6)),
           ref_layers.rope(_jax(x, jdt), jnp.asarray(pos), 1e6), tol)
    h = rng.standard_normal((2, 6, 16), np.float32)
    w = {n: rng.standard_normal(s, np.float32) * 0.25 for n, s in
         (("w_up", (16, 32)), ("w_gate", (16, 32)), ("w_down", (32, 16)))}
    for act in ("silu", "gelu"):
        got = layers.mlp(torch.from_numpy(h).to(tdt),
                         {n: torch.from_numpy(a).to(tdt) for n, a in w.items()},
                         act)
        want = ref_layers.mlp(_jax(h, jdt), {n: _jax(a, jdt)
                                             for n, a in w.items()}, None, act)
        _close(_np(got), want, tol)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_gelu_matches_the_reference_bit_for_bit(jit):
    """hubert's MLP: in bf16 the reference's ``jax.nn.gelu`` (tanh form)
    rounds after every step with its constants in bf16, eager and jitted;
    so does the port's written-out ``gelu``.  ``F.gelu`` rounds once and
    differs from it in about a fifth of these values."""
    x = (3 * np.random.default_rng(0).standard_normal(100_000)) \
        .astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    fn = jax.jit(jax.nn.gelu) if jit else jax.nn.gelu
    np.testing.assert_array_equal(
        layers.gelu(xt).float().numpy(),
        np.asarray(fn(_jax(x, jnp.bfloat16)), np.float32))
    rounded_once = torch.nn.functional.gelu(xt, approximate="tanh")
    assert (rounded_once != layers.gelu(xt)).float().mean() > 0.1


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("causal,window,prefix_len,q_offset,block_kv", [
    (True, layers.GLOBAL_WINDOW, None, 0, 16),
    (True, 8, None, 0, 16),
    (False, layers.GLOBAL_WINDOW, None, 0, 512),
    (True, layers.GLOBAL_WINDOW, 5, 0, 7),
    (True, layers.GLOBAL_WINDOW, None, 12, 16),
])
def test_blockwise_attention_matches(dt, causal, window, prefix_len, q_offset,
                                     block_kv):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(2)
    Sq = 20 if q_offset == 0 else 8
    q = rng.standard_normal((2, Sq, 4, 16), np.float32)
    k = rng.standard_normal((2, 20, 2, 16), np.float32)
    v = rng.standard_normal((2, 20, 2, 16), np.float32)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len,
              q_offset=q_offset, block_kv=block_kv)
    got = layers.blockwise_attention(*(torch.from_numpy(a).to(tdt)
                                       for a in (q, k, v)), **kw)
    want = ref_layers.blockwise_attention(*(_jax(a, jdt) for a in (q, k, v)),
                                          **kw)
    assert got.dtype == tdt
    _close(_np(got), want, tol)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("window", [layers.GLOBAL_WINDOW, 4])
@pytest.mark.parametrize("cache_len", [9, (9, 5)], ids=["shared", "per-row"])
def test_decode_attention_matches(dt, window, cache_len):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 4, 16), np.float32)
    kc = rng.standard_normal((2, 12, 2, 16), np.float32)
    vc = rng.standard_normal((2, 12, 2, 16), np.float32)
    clen = torch.tensor(cache_len) if isinstance(cache_len, tuple) else cache_len
    got = layers.decode_attention(*(torch.from_numpy(a).to(tdt)
                                    for a in (q, kc, vc)), clen, window=window)
    want = ref_layers.decode_attention(*(_jax(a, jdt) for a in (q, kc, vc)),
                                       jnp.asarray(cache_len, jnp.int32),
                                       window=window)
    _close(_np(got), want, tol)


# ---------------------------------------------------------------------------
# the model and the serving steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_matches(arch, dt):
    rcfg, rparams, pcfg, pparams = _models(arch, dt)
    inputs = _inputs(pcfg, 2, 16)
    tokens, kw = _forward_args(inputs, "torch")
    got, aux = forward(pparams, pcfg, tokens, **kw)
    tokens, kw = _forward_args(inputs, "jax")
    want, raux = jax.jit(ref_forward, static_argnums=1)(
        rparams, rcfg, tokens, **kw)
    assert got.shape == (2, 16, pcfg.vocab) and got.dtype == pcfg.dtype
    _close(_np(got), want, DTYPES[dt][2])
    if pcfg.family == "moe":
        # the load-balance loss averaged over the layers, in f32 from the
        # router's logits; in bf16 those follow the bf16 hidden states
        assert aux.dtype == torch.float32 and float(aux) > 0
        _close(aux.numpy(), raux, 1e-6 if dt == "f32" else DTYPES[dt][2])
    else:
        assert float(aux) == float(raux) == 0.0


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_teacher_forced_decode_matches(arch, dt):
    rcfg, rparams, pcfg, pparams = _models(arch, dt)
    B, S = 2, 10
    tokens = _tokens(pcfg, B, S, seed=1)
    cache = init_cache(pcfg, B, max_len=S + 2, device="cpu")
    rcache = ref_init_cache(rcfg, B, max_len=S + 2)
    rstep = jax.jit(ref_decode_step, static_argnums=1)
    # rwkv6's bf16 caches are held to the reference's eager run: its jitted
    # and eager runs end 0.33-0.35 apart in the f32 WKV state within these
    # 10 steps (beyond 5e-2), and the port follows the eager run (within
    # 1e-5; the token-shift states bit-equal).  moe's bf16 logits and caches
    # too: its jitted run flips one routing decision at step 9 against its
    # own eager run (0.44 apart at the logits), and the port's steps equal
    # the eager run's exactly
    eager = pcfg.family in ("rwkv6", "moe") and dt == "bf16"
    held = ref_init_cache(rcfg, B, max_len=S + 2)
    for t in range(S):
        got, cache = decode_step(pparams, pcfg, cache,
                                 torch.from_numpy(tokens[:, t:t + 1]))
        want, rcache = rstep(rparams, rcfg, rcache,
                             jnp.asarray(tokens[:, t:t + 1]))
        if eager:
            with jax.disable_jit():
                held_logits, held = ref_decode_step(
                    rparams, rcfg, held, jnp.asarray(tokens[:, t:t + 1]))
            if pcfg.family == "moe":
                want = held_logits
        assert got.shape == (B, 1, pcfg.vocab)
        _close(_np(got), want, DTYPES[dt][2])
    assert cache["len"] == S == int(rcache["len"])
    assert cache.keys() == rcache.keys()
    # every cache tensor, but not zamba2's in bf16: there the caches drift
    # beyond 5e-2 within these 10 steps between the reference's own jitted
    # and eager runs as much as between the port and the reference (0.14
    # in k, about 1.0 in the f32 SSM state), while the logits hold 5e-2
    names = (() if pcfg.family == "zamba2" and dt == "bf16"
             else sorted(cache.keys() - {"len"}))
    for name in names:
        _close(_np(cache[name]), (held if eager else rcache)[name],
               DTYPES[dt][2])
    past_the_end = torch.zeros((B, 1), dtype=torch.int32)
    if "k" in cache:
        with pytest.raises(ValueError, match="does not fit"):
            for _ in range(3):
                decode_step(pparams, pcfg, cache, past_the_end)
    else:                         # an RWKV cache has no length limit
        for _ in range(3):
            decode_step(pparams, pcfg, cache, past_the_end)
        assert cache["len"] == S + 3


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_fn_matches(arch, dt):
    """The serving batch: ``tokens`` (and paligemma's ``img_embeds``), or
    hubert's ``features`` and ``mask``."""
    rcfg, rparams, pcfg, pparams = _models(arch, dt)
    inputs = _inputs(pcfg, 3, 12, seed=2)
    if "feat_mask" in inputs:
        inputs["mask"] = inputs.pop("feat_mask")
    got = prefill_fn(pcfg)(pparams, {k: torch.from_numpy(a)
                                     for k, a in inputs.items()})
    want = jax.jit(ref_prefill_fn(rcfg))(rparams, {k: jnp.asarray(a)
                                                   for k, a in inputs.items()})
    assert got.shape == (3, pcfg.vocab)
    _close(_np(got), want, DTYPES[dt][2])


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_greedy_generate_matches_in_f32(arch):
    rcfg, rparams, pcfg, pparams = _models(arch, "f32")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, pcfg.vocab, n).astype(np.int32)
               for n in (3, 7, 5)]
    got = greedy_generate(pparams, pcfg, prompts, max_new=6, max_len=16)
    want = ref_greedy_generate(rparams, rcfg, prompts, max_new=6, max_len=16)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_decode_fn_returns_the_argmax():
    _, _, pcfg, pparams = _models("qwen3-8b", "f32")
    cache = init_cache(pcfg, 2, 4, device="cpu")
    tok, logits, cache = decode_fn(pcfg)(pparams, cache,
                                         torch.tensor([[1], [2]]))
    assert tok.dtype == torch.int32 and tok.shape == (2, 1)
    assert torch.equal(tok[:, 0].long(), logits[:, -1].argmax(-1))
    assert cache["len"] == 1


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_serve_main_on_cpu(arch, capsys):
    out = main(["--arch", arch, "--smoke", "--device", "cpu",
                "--requests", "3", "--max-new", "5"])
    toks = out["tokens"]
    assert toks.shape == (3, 5) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < smoke_config(arch).vocab)).all()
    assert out["tok_s"] > 0
    assert f"arch={arch}" in capsys.readouterr().out


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_lm_loss_matches(family, dt):
    """Next-token loss with and without a loss mask (paligemma behind its
    image prefix); hubert's masked prediction under two frame masks."""
    rcfg, rparams, pcfg, pparams = _models(FAMILY_ARCHS[family], dt)
    inputs = _inputs(pcfg, 2, 17, seed=5)
    mask = np.random.default_rng(6).random((2, 17)) < 0.7
    for loss_mask in (None, mask):
        if family == "hubert":
            frames = inputs["feat_mask"] if loss_mask is None else loss_mask
            arrays = {"features": inputs["features"], "mask": frames,
                      "targets": _tokens(pcfg, 2, 17, seed=7)}
        else:
            arrays = dict(inputs)
            if loss_mask is not None:
                arrays["loss_mask"] = loss_mask
        batch = {k: torch.from_numpy(a) for k, a in arrays.items()}
        rbatch = {k: jnp.asarray(a) for k, a in arrays.items()}
        total, metrics = lm_loss(pparams, pcfg, batch)
        rtotal, rmetrics = jax.jit(ref_lm_loss, static_argnums=1)(
            rparams, rcfg, rbatch)
        tol = DTYPES[dt][2]
        _close(total.detach().numpy(), rtotal, tol)
        for name in ("loss", "zloss", "aux"):
            assert metrics[name].dtype == torch.float32, name
            _close(metrics[name].detach().numpy(), rmetrics[name], tol)
        want_tokens = (int(arrays["mask"].sum()) if family == "hubert"
                       else 32 if loss_mask is None
                       else int(loss_mask[:, 1:].sum()))
        assert int(metrics["tokens"]) == int(rmetrics["tokens"]) == \
            want_tokens
        if family != "moe":
            assert float(metrics["aux"]) == 0.0
