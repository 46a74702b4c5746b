"""The window sweep (`dilithium_tpu_torch.tools.sweep_window`) on the CPU
at level 2, on all four of its paths: a queue of 8, W = 2, 4 and 8, one
reading of one call. Its JSON line has a rate and a spread for every W
and names the best, and the signatures at every W equal `oracle.sign`
under each message's key.

Two tests: a port file of two tests or fewer is handed out last by
xdist's loadfile order (see ROADMAP)."""

import json

import numpy as np
import pytest
import torch

from dilithium_tpu_torch import oracle
from dilithium_tpu_torch.tools import sweep_window

LEVEL, QUEUE, WINDOWS = 2, 8, (2, 4, 8)


# ids as "first path-keys"
@pytest.mark.parametrize("paths, nkeys", [(("mxu", "bytes"), 1), (("keys", "stream"), 2)], ids=["mxu-1", "keys-2"])
def test_sweep_matches_the_oracle(paths, nkeys, monkeypatch, capsys):
    kept = {}
    real_setup, real_measure = sweep_window.setup, sweep_window.measure

    def setup(*args, **kwargs):
        kept["case"] = real_setup(*args, **kwargs)
        return kept["case"]

    def measure(*args, **kwargs):
        kept["out"] = real_measure(*args, **kwargs)
        return kept["out"]

    monkeypatch.setattr(sweep_window, "setup", setup)
    monkeypatch.setattr(sweep_window, "measure", measure)
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the shapes are tiny, and the test workers share the cores
    try:
        for path in paths:
            rc = sweep_window.main(["--level", str(LEVEL), "--path", path, "--windows", *map(str, WINDOWS),
                                    "--queue", str(QUEUE), "--calls", "1", "--readings", "1",
                                    "--nkeys", str(nkeys), "--device", "cpu"])
            assert rc == 0, path

            line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert (line["level"], line["path"], line["device"], line["queue"]) == (LEVEL, path, "cpu", QUEUE)
            assert list(line["values"]) == list(line["spread"]) == [str(w) for w in WINDOWS]
            assert all(v > 0 for v in line["values"].values()) and set(line["spread"].values()) == {0.0}
            assert line["best_window"] == max(WINDOWS, key=lambda w: line["values"][str(w)])

            case = kept["case"]
            rates, first, differ = kept["out"]
            assert differ == [] and all(len(r) == 1 for r in rates.values())
            want_keys = nkeys if path == "keys" else 1
            assert len(case.sks) == want_keys and set(case.key_of_row.tolist()) == set(range(want_keys))
            sk_o = np.stack([np.frombuffer(s, dtype=np.uint8) for s in case.sks])
            sig_o, _ = oracle.sign(LEVEL, sk_o[case.key_of_row], case.mus)
            np.testing.assert_array_equal(first, sig_o, err_msg=path)
    finally:
        torch.set_num_threads(n)
