"""The port's data pipeline against the JAX package's: ``host_batch`` bit
for bit for every family (tokens; paligemma's image embeddings; hubert's
features, mask and targets) and host count, and the ``Prefetcher``."""
import numpy as np
import pytest

from repro.configs import smoke_config as ref_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import host_batch as ref_host_batch
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, host_batch

ARCHS = ["qwen3-8b", "h2o-danube-1.8b", "deepseek-moe-16b", "rwkv6-1.6b",
         "zamba2-2.7b", "hubert-xlarge", "paligemma-3b"]


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_host_batch_is_bit_equal_to_the_reference(arch, n_hosts):
    cfg, rcfg = smoke_config(arch), ref_smoke_config(arch)
    dc = DataConfig(seed=7, global_batch=8, seq_len=16)
    rdc = RefDataConfig(seed=7, global_batch=8, seq_len=16)
    for step in (0, 3):
        for host in range(n_hosts):
            got = host_batch(cfg, dc, step, host, n_hosts)
            want = ref_host_batch(rcfg, rdc, step, host, n_hosts)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_data_determinism_across_host_counts():
    cfg = smoke_config("qwen3-8b")
    dc = DataConfig(global_batch=8, seq_len=16)
    full = host_batch(cfg, dc, step=3, host_id=0, n_hosts=1)
    h0 = host_batch(cfg, dc, step=3, host_id=0, n_hosts=2)
    h1 = host_batch(cfg, dc, step=3, host_id=1, n_hosts=2)
    np.testing.assert_array_equal(full["tokens"],
                                  np.concatenate([h0["tokens"], h1["tokens"]]))


@pytest.mark.parametrize("arch", ["qwen3-8b", "hubert-xlarge"])
def test_prefetcher_yields_sequential_steps(arch):
    cfg = smoke_config(arch)
    dc = DataConfig(global_batch=4, seq_len=8)
    pf = Prefetcher(cfg, dc, start_step=7, host_id=1, n_hosts=2)
    s0, b0 = next(pf)
    s1, b1 = next(pf)
    pf.close()
    assert (s0, s1) == (7, 8)
    for step, b in ((7, b0), (8, b1)):
        want = ref_host_batch(ref_smoke_config(arch),
                              RefDataConfig(global_batch=4, seq_len=8), step,
                              1, 2)
        for k in want:
            np.testing.assert_array_equal(b[k], want[k])
