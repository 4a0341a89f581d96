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
    bg = CONF["database"]["background"]
    a = data.sequences(spec, 3, 5, bg, data.generator(2**31 + 5, "cpu"))
    b = data.sequences(spec, 3, 5, bg, data.generator(2**31 + 5, "cpu"))
    c = data.sequences(spec, 3, 5, bg, data.generator(2**31 + 6, "cpu"))
    assert a.shape == (3, 5000) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])  # distinct sequences
    n = a == 4
    assert n[:, :10].all() and n[:, 2000:2300].all() and n[:, -10:].all()
    assert n.sum() == 3 * 320
    assert set(np.unique(a[:, 10:2000])) == {0, 1, 2, 3}


#: Amino-acid frequencies over ``ACDEFGHIKLMNPQRSTVWY`` and 0 for ``X``.
PROTEIN_BG = [0.08, 0.02, 0.05, 0.06, 0.04, 0.07, 0.02, 0.06, 0.06, 0.1, 0.02, 0.04,
              0.05, 0.04, 0.05, 0.07, 0.05, 0.07, 0.01, 0.04, 0.0]


def test_background_composition_draws_its_frequencies():
    spec = {"length": 200_000, "composition": "background"}
    a = data.sequences(spec, 2, 21, PROTEIN_BG, data.generator(2**31 + 9, "cpu"))
    b = data.sequences(spec, 2, 21, PROTEIN_BG, data.generator(2**31 + 9, "cpu"))
    assert a.shape == (2, 200_000) and np.array_equal(a, b)
    share = np.bincount(a.ravel(), minlength=21) / a.size
    assert share[20] == 0  # never the wildcard
    assert np.abs(share - np.asarray(PROTEIN_BG)).max() < 3e-3
    uniform = data.sequences({"length": 200_000}, 1, 21, PROTEIN_BG,
                             data.generator(1, "cpu"))
    assert np.abs(np.bincount(uniform.ravel(), minlength=21)[:20] / 2e5 - 0.05).max() < 3e-3


def test_record_sets_hold_the_mix_in_orders_of_their_own():
    spec = {"records": {"3": 4, "40": 3, "2000": 2}}
    bg = CONF["database"]["background"]
    a = data.record_sets(spec, 3, 5, bg, data.generator(2**31 + 3, "cpu"))
    b = data.record_sets(spec, 3, 5, bg, data.generator(2**31 + 3, "cpu"))
    assert len(a) == 3
    for x, y in zip(a, b):
        assert len(x) == len(y) == 9
        assert all(np.array_equal(r, q) and r.dtype == np.uint8 for r, q in zip(x, y))
        assert sorted(len(r) for r in x) == [3] * 4 + [40] * 3 + [2000] * 2
        assert max(int(r.max()) for r in x) <= 3
    assert len({tuple(len(r) for r in x) for x in a}) > 1  # orders differ


def test_dna_draws_are_the_parents(tiny_root):
    """The DNA tiny cell's counts, sequences and thresholds, as the
    harness draws and chains them on the CPU, hash to the values they had
    before the harness took other alphabets and record sets: a change to
    the DNA draws changes every DNA cell's inputs and fails here."""
    import hashlib

    from lightmotif_tpu_torch import DNA
    from motifbench import harness
    from tiny_cell import TINY

    c = harness.cell(tiny_root, TINY, tiny_root)
    db = c.config["database"]
    digest = hashlib.sha256()
    counts = data.database_counts(db, DNA.size, data.generator(db["seed"], "cpu"))
    for x in counts:
        digest.update(np.ascontiguousarray(x).tobytes())
    codes = data.sequences(c.config["sequence"], int(c.traffic["sequences"]), DNA.size,
                           db["background"], data.generator(2**31 + 5, "cpu"))
    digest.update(codes.tobytes())
    _, thresholds = harness.program_chain(counts, c.config, float(c.traffic["pvalue"]))
    digest.update(thresholds.tobytes())
    assert digest.hexdigest() == (
        "cd02cf6435aa3c331d052c4f7a9a7b16dd361d21346770ec49c3b0dea0d7ec93")
