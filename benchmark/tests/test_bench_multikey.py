"""Whole runs of the multi-tenant cell, d3-sign-multikey, on the CPU at a
small batch over the configuration's 256 keys: sound, it comes out
correct with each of its end-to-end metrics; with a fault planted in the
program under the timed path, or with its control, `correct` comes out
false. The faults of its own break the guarantee that each message is
signed under its own tenant's key, or answer fewer or older signatures
than asked. On the card (`-m card`), one short run at a small batch,
untraced and traced."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import faults
from dilithium_tpu_torch import api, scheme

CELL = "d3-sign-multikey"
SEED = 3141592653
SMALL = {"batch": 6, "distinct_calls": 3, "warm_calls": 1, "sample_per_call": 6, "max_checked": 18}
CARD = {"batch": 256, "distinct_calls": 4}


def wrong_key(ctx) -> None:
    """Each message is signed under the next tenant's key (its own tr
    still in mu)."""
    stream = scheme.sign_stream_keys
    scheme.sign_stream_keys = lambda eks, key_idx, *a, **k: stream(eks, (key_idx + 1) % eks.key.shape[0], *a, **k)


def half_batch(ctx) -> None:
    """Only the first half of a call's pairs is signed; the rest gets
    copies of its signatures."""
    sign = api.MultiSigner.sign

    def half(self, key_message_pairs, randomized=False):
        h = max(1, len(key_message_pairs) // 2)
        return (sign(self, key_message_pairs[:h], randomized) * 2)[:len(key_message_pairs)]

    api.MultiSigner.sign = half


def stale_answers(ctx) -> None:
    """After its first call, the signer returns that call's signatures
    again."""
    sign = api.MultiSigner.sign
    first = []

    def once(self, key_message_pairs, randomized=False):
        if not first:
            first.append(sign(self, key_message_pairs, randomized))
        return first[0]

    api.MultiSigner.sign = once


HOOKS = [None, faults.altered_answers, wrong_key, half_batch, stale_answers, control.control_for(CELL)]


@pytest.fixture
def restore(monkeypatch):
    """Whatever a hook patches in this process is put back afterwards."""
    for obj, name in faults.PATCHED + [(api.MultiSigner, "sign"), (scheme, "sign_stream_keys")]:
        monkeypatch.setattr(obj, name, getattr(obj, name))


@pytest.mark.parametrize("hook", HOOKS, ids=[f"{CELL}-{h.__name__ if h else 'sound'}" for h in HOOKS])
def test_run(hook, restore):
    line = harness.run_cell(CELL, SEED, 1.0, False, device="cpu", overrides=SMALL, hook=hook)
    assert line["attempted"] > 0
    if hook is None:
        assert line["correct"], line["checks"]
        assert set(line["metrics"]) == {m["name"] for m in harness.cell_metrics(CELL, False)}
    else:
        assert not line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.card
def test_cell_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    for trace in (False, True):
        line = harness.run_cell(CELL, 2718281828, 2.0, trace, device="cuda", overrides=CARD)
        assert line["correct"], line["checks"]
        assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
        assert set(line["metrics"]) == {m["name"] for m in harness.cell_metrics(CELL, trace)}
        if trace:
            assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
