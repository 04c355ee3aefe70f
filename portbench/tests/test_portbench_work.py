"""The frozen least-work counts equal ``chip_smoke.py``'s at PERF.md §6's
shapes, and the model-FLOP count equals a count by hand."""
import importlib.util

import pytest

from portbench import harness
from portbench.work import attention, rwkv6, ssd, wkv, zamba2


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", harness.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = chip_smoke()


@pytest.mark.parametrize("case", [
    (2, 2048, 2048, 32, 8, 128, "bfloat16", True, 0, 0),
    (2, 2048, 2048, 32, 32, 80, "bfloat16", True, 0, 0),
    (1, 8192, 8192, 32, 8, 80, "bfloat16", True, 4096, 0),
    (2, 2304, 2304, 8, 1, 256, "float32", True, 0, 256),
    (2, 2048, 2048, 16, 16, 80, "bfloat16", False, 0, 0),
    (1, 300, 300, 8, 2, 128, "bfloat16", True, 0, 100)])
def test_attention_bounds(case):
    assert attention.attention_bound(*case) == CS.attention_bound(*case)
    B, S, _, H, KV, D, dt, causal, win, pre = case
    assert (attention.attention_bwd_bound(B, S, H, KV, D, dt, causal, win,
                                          pre)
            == CS.attention_bwd_bound(B, S, H, KV, D, dt, causal, win, pre))


@pytest.mark.parametrize("shape", [(2, 2048, 80, 64, 64), (4, 2048, 80, 64,
                                                            64),
                                   (1, 8100, 80, 64, 64), (2, 2000, 80, 64,
                                                           64)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_bounds(shape, dtype):
    assert ssd.ssd_bound(*shape, dtype) == CS.ssd_bound(*shape, dtype)
    assert ssd.ssd_bwd_bound(*shape, dtype) == CS.ssd_bwd_bound(*shape, dtype)


@pytest.mark.parametrize("shape", [(2, 2048, 32, 64), (4, 2048, 32, 64),
                                   (2, 2000, 32, 64), (3, 200, 8, 16)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wkv_bounds(shape, dtype):
    assert wkv.wkv_bound(*shape, dtype) == CS.wkv_bound(*shape, dtype)
    assert wkv.wkv_bwd_bound(*shape, dtype) == CS.wkv_bwd_bound(*shape, dtype)


def test_zamba2_flops_by_hand():
    """4 Mamba-2 layers of width 64 and the shared block after every 2
    (applied twice), at B = 1, S = 8."""
    m = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
             vocab=256, ssm_state=16, ssm_conv=4, ssm_head_dim=16,
             shared_attn_every=2, mlp_act="silu")
    d, d_in, N, H, f, V = 64, 128, 16, 8, 128, 256
    mamba = d * (2 * d_in + 2 * N + H) + d_in * d + 4 * (d_in + 2 * N)
    shared = 4 * d * d + 3 * d * f
    per_token = 4 * mamba + 2 * shared + d * V
    assert zamba2.weight_macs_per_token(m) == per_token
    pairs = 8 * 9 // 2
    attn = 2 * 4 * 16 * pairs * 4          # 2 applications, 4 heads of 16
    # one chunk of 8 steps: C B^T once, per head C S^T, W x, the update
    scan = 4 * (2 * N * pairs + H * (2 * 8 * 16 * N + 2 * 16 * pairs
                                     + 2 * 8 * 16 * N))
    assert zamba2.forward_flops(m, 1, 8) == 2 * per_token * 8 + attn + scan


def test_rwkv6_flops_by_hand():
    m = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256)
    per_token = 2 * (7 * 64 * 64 + 2 * 64 * 128) + 64 * 256
    assert rwkv6.weight_macs_per_token(m) == per_token
    scan = 2 * 4 * 2 * (2 * 8 * 16 * 16 + 16 * 8 * 7 + 2 * 8 * 16)
    assert rwkv6.forward_flops(m, 1, 8) == 2 * per_token * 8 + scan
