"""The inputs repeat from their seeds: the database from the
configuration's, the sequences from the run's."""

import json

import numpy as np

from tiny_cell import REPO
from motifbench import data

CONF = json.loads((REPO / "motifbench/configs/jaspar2024-chr1.json").read_text())


def small_database():
    db = dict(CONF["database"])
    db["lengths"] = {"5": 3, "9": 2, "35": 1}
    db["profiles"] = 6
    return db


def test_database_repeats_from_its_seed():
    db = small_database()
    a = data.database_counts(db, 5, data.generator(db["seed"], "cpu"))
    b = data.database_counts(db, 5, data.generator(db["seed"], "cpu"))
    c = data.database_counts(db, 5, data.generator(db["seed"] + 1, "cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, c))


def test_database_shapes_follow_the_length_mix():
    db = small_database()
    counts = data.database_counts(db, 5, data.generator(7, "cpu"))
    assert sorted(c.shape[0] for c in counts) == [5, 5, 5, 9, 9, 35]
    for c in counts:
        assert c.dtype == np.uint32 and c.shape[1] == 5
        assert (c[:, 4] == 0).all()  # the wildcard column
        assert (c.sum(axis=1) == db["sites"]).all()


def test_real_length_mix_is_the_stand_ins():
    lengths = data.profile_lengths(CONF["database"])
    assert lengths.size == 2346
    assert lengths.min() == 5 and lengths.max() == 35
    assert 0.9 < np.mean(lengths <= 20) < 0.94


def test_sequences_repeat_from_the_run_seed_and_hold_their_n_runs():
    spec = {"length": 5000, "n_runs": [[0, 10], [2000, 300], [-10, 10]]}
    a = data.sequences(spec, 3, 4, data.generator(2**31 + 5, "cpu"))
    b = data.sequences(spec, 3, 4, data.generator(2**31 + 5, "cpu"))
    c = data.sequences(spec, 3, 4, data.generator(2**31 + 6, "cpu"))
    assert a.shape == (3, 5000) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])  # distinct sequences
    n = a == 4
    assert n[:, :10].all() and n[:, 2000:2300].all() and n[:, -10:].all()
    assert n.sum() == 3 * 320
    assert set(np.unique(a[:, 10:2000])) == {0, 1, 2, 3}
