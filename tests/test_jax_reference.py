"""The recorded JAX reference (`tests/data/jax_reference.npz`) is what the
JAX package computes today: every case of `tests/jax_reference.py` run
again and compared with the file, array for array and digest for digest.

Slow: it runs, in one place, all the JAX work that the port's tests read
from the file instead (jitted scheme graphs and the Pallas NTT under the
interpreter), so tier-1 (`-m 'not slow'`) leaves it out. Run it after
re-recording: `python -m pytest tests/test_jax_reference.py -m slow`."""

import numpy as np
import pytest

from jax_reference import CASES, Digest, _load, jax_ref, record


@pytest.mark.slow
def test_recorded_reference_is_current():
    assert sorted(_load()) == sorted(CASES)
    for case in CASES:
        fresh, ref = record(case), jax_ref(case)
        assert sorted(fresh) == sorted(ref), case
        for name, v in fresh.items():
            what = f"{case}/{name}"
            if isinstance(v, Digest):
                assert ref[name] == v, what
            else:
                assert not isinstance(ref[name], Digest), what
                assert ref[name].dtype == v.dtype and ref[name].shape == v.shape, what
                np.testing.assert_array_equal(ref[name], v, err_msg=what)
