"""Residue-feature stores (beyond-paper, ``auto_residues``/``residues``)
in the port, held against the reference: the cases of
``tests/test_residues.py::TestStoreWithResidues``.

The reference builds and saves each store; the port opens the save on
the CPU (its fused tier runs K1's plain version over the residue
positions), answers every key losslessly and byte for byte as the
reference does, absent keys included, saves the store again and answers
the same after its own reopen, and the reference opens the port's save
with the same answers.
"""

import numpy as np

import repro
import repro_torch
from repro.core import DeepMappingConfig as JConfig
from repro.core import DeepMappingStore as JStore
from repro.core.trainer import TrainConfig as JTrainConfig
from repro.data import customer_demographics_like
from torch_port_util import assert_values_equal


def answers_equal(a, b):
    (av, ae), (bv, be) = a, b
    assert ae.tobytes() == be.tobytes()
    assert_values_equal(av, bv)


def probe_of(table):
    absent = np.array([-1, table.max_key + 1, table.max_key + 977, 2**40], dtype=np.int64)
    return np.concatenate([table.keys, absent])


def hold(table, jstore, path, out):
    """The port's copy of the reference store saved at ``path``: every
    key lossless and as the reference answers, before and after the
    port's own save to ``out`` and reopen; the reference reopens that
    save."""
    store = repro_torch.open(str(path), device="cpu")
    assert store.encoder.residues == jstore.encoder.residues
    probe = probe_of(table)
    want = jstore.lookup(probe)
    got = store.lookup(probe)
    answers_equal(got, want)
    vals, exists = got
    n = table.num_rows
    assert exists[:n].all() and not exists[n:].any()
    for c in table.columns:
        np.testing.assert_array_equal(vals[c][:n], table.columns[c])
    store.save(str(out))
    again = repro_torch.open(str(out), device="cpu")
    assert again.encoder.residues == jstore.encoder.residues
    answers_equal(again.lookup(probe), want)
    answers_equal(repro.open(str(out)).lookup(probe), want)
    return store


class TestStoreWithResidues:
    def test_lossless_and_better_memorization(self, tmp_path):
        table = customer_demographics_like(n=8000)
        train = JTrainConfig(epochs=25, batch_size=2048)
        ports = {}
        for name, kw in (("plain", {}), ("auto", {"auto_residues": True})):
            jstore = JStore.build(table, JConfig(shared=(64,), private=(16,), train=train, **kw))
            jstore.save(str(tmp_path / name))
            ports[name] = hold(table, jstore, tmp_path / name, tmp_path / f"{name}_port")
            assert ports[name].memorized_fraction() == jstore.memorized_fraction()
        assert ports["auto"].encoder.residues and not ports["plain"].encoder.residues
        assert ports["auto"].memorized_fraction() > ports["plain"].memorized_fraction()

    def test_residue_store_serializes(self, tmp_path):
        """The reference's small store with fixed residues (7, 49)."""
        table = customer_demographics_like(n=2000)
        jstore = JStore.build(table, JConfig(shared=(32,), private=(), residues=(7, 49),
                                             train=JTrainConfig(epochs=5, batch_size=512)))
        jstore.save(str(tmp_path / "s"))
        assert hold(table, jstore, tmp_path / "s", tmp_path / "port").encoder.residues == (7, 49)
