"""The port's synthetic data pipeline against the reference's: the token
batches of `make_batch` are equal for several (seed, step) pairs, and the
port's `--streaming` launcher feeds step 0 of it, as the reference's does
(`src/repro/launch/serve.py`, its `--streaming` branch)."""
import argparse

import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import make_batch as ref_make_batch
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import serve
from repro_torch.streaming import executor as executor_mod

RCFG = ref_config("gemma-7b", smoke=True)
CFG = get_config("gemma-7b", smoke=True)


@pytest.mark.parametrize("seed,step", [(1234, 0), (1234, 7), (0, 0),
                                       (99, 123456)])
@pytest.mark.parametrize("seq_len,batch", [(8, 2), (32, 4)])
def test_make_batch_matches_reference(seed, step, seq_len, batch):
    got = make_batch(CFG, DataConfig(seq_len, batch, seed), step)
    want = ref_make_batch(RCFG, RefDataConfig(seq_len, batch, seed), step)
    assert set(got) == set(want) == {"tokens"}
    assert got["tokens"].dtype == want["tokens"].dtype
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_streaming_cli_feeds_make_batch(monkeypatch, capsys):
    seen = []
    forward = executor_mod.StreamingExecutor.forward

    def recording(self, batch):
        seen.append(batch["tokens"].numpy().copy())
        return forward(self, batch)

    monkeypatch.setattr(executor_mod.StreamingExecutor, "forward", recording)
    serve._run_streaming(argparse.Namespace(
        arch="gemma-7b", smoke=True, device="cpu", arena_slots=2, batch=2,
        prompt_len=8))
    assert capsys.readouterr().out.startswith("streaming forward: ")
    want = ref_make_batch(RCFG, RefDataConfig(seq_len=8, global_batch=2), 0)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], want["tokens"])
