"""Shared helpers of the ``test_torch_*`` files: the same inputs, made
from a seed with numpy, for both the JAX reference and the port.

Params are drawn here (He-normal weights, small random biases) in the
reference's tree layout with numpy leaves, which ``repro``'s functions
accept as they are and ``params_from_numpy`` carries into the port.
"""

import numpy as np

from repro.core.model import MLPSpec as JSpec
from repro_torch.core.convert import params_from_numpy
from repro_torch.core.model import MLPSpec

#: Logits: the two frameworks sum in different orders.
LOGIT_TOL = 1e-5
#: Codes may differ only on rows whose reference top-two margin is below this.
MARGIN_TOL = 1e-5


def spec_pair(shared, private, cards, base=10, width=5):
    kw = dict(
        base=base, width=width, shared=tuple(shared),
        private={f"t{i}": tuple(private) for i in range(len(cards))},
        out_cards={f"t{i}": c for i, c in enumerate(cards)},
    )
    return JSpec(**kw), MLPSpec(**kw)


def np_params(spec, seed=0):
    """He-normal weights and small random biases, numpy float32, in the
    reference layout (first layer from the input is (width, base, out))."""
    rng = np.random.default_rng(seed)

    def dense(i, o):
        w = (rng.standard_normal((i, o)) * np.sqrt(2.0 / i)).astype(np.float32)
        return {"w": w, "b": (0.05 * rng.standard_normal(o)).astype(np.float32)}

    def first(o):
        p = dense(spec.feature_dim, o)
        return {"w": p["w"].reshape(spec.width, spec.base, o), "b": p["b"]}

    params = {"shared": [], "heads": {}}
    d = None
    for h in spec.shared:
        params["shared"].append(first(h) if d is None else dense(d, h))
        d = h
    for t in spec.tasks:
        hd, hidden = d, []
        for h in spec.private_map[t]:
            hidden.append(first(h) if hd is None else dense(hd, h))
            hd = h
        card = spec.card_map[t]
        params["heads"][t] = {"hidden": hidden, "out": first(card) if hd is None else dense(hd, card)}
    return params


def both_params(spec, seed=0):
    """``(numpy tree for repro, tensor tree on the CPU for repro_torch)``."""
    p = np_params(spec, seed)
    return p, params_from_numpy(p, "cpu")


def margins(logits_by_task, tasks):
    """Top-two logit margin per row and task (inf where card < 2)."""
    out = []
    for t in tasks:
        lg = np.asarray(logits_by_task[t])
        if lg.shape[1] < 2:
            out.append(np.full(lg.shape[0], np.inf))
        else:
            top = np.sort(lg, axis=1)[:, -2:]
            out.append(top[:, 1] - top[:, 0])
    return np.stack(out, axis=1)


def assert_codes_close(got, want, marg):
    """Codes equal except on near-tie rows of the reference; returns the
    number of such rows, which must be small."""
    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    assert (marg[diff] < MARGIN_TOL).all(), "codes differ on a row with a clear margin"
    n = int(diff.any(axis=1).sum())
    assert n <= max(1, got.shape[0] // 100), n
    return n


def store_pair(table, shared, private, epochs=8, use_pallas=False, seed=0):
    """The same DeepMapping store built by both packages: the reference
    trainer runs a few epochs on ``table``, and its weights (as numpy)
    go to the reference's ``build`` (``use_pallas`` as given) and to the
    port's (``use_kernels=True`` on the CPU, so the fused tier runs K1's
    plain version).  Each package finds its own T_aux with its own
    engine.  Returns ``(reference store, port store, numpy params)``."""
    import jax

    from repro.core import DeepMappingConfig as JConfig
    from repro.core import DeepMappingStore as JStore
    from repro.core import Table as JTable
    from repro.core.encoding import KeyEncoder as JEncoder
    from repro.core.encoding import build_codecs as j_build_codecs
    from repro.core.trainer import TrainConfig, train
    from repro_torch.core import DeepMappingConfig, DeepMappingStore, Table

    enc = JEncoder(table.max_key, base=10)
    codecs = j_build_codecs(table.columns)
    kw = dict(base=10, width=enc.width, shared=tuple(shared),
              private={c: tuple(private) for c in table.columns},
              out_cards={c: codecs[c].cardinality for c in table.columns})
    jspec, spec = JSpec(**kw), MLPSpec(**kw)
    codes = np.stack([codecs[t].codes for t in jspec.tasks], axis=1)
    params, _, _ = train(jspec, enc.digits(table.keys), codes,
                         TrainConfig(epochs=epochs, batch_size=512, seed=seed))
    params = jax.device_get(params)

    def copy(cls):
        return cls(keys=table.keys.copy(),
                   columns={c: v.copy() for c, v in table.columns.items()})

    jstore = JStore.build(copy(JTable), JConfig(shared=tuple(shared), private=tuple(private),
                                                use_pallas=use_pallas),
                          spec=jspec, params=params)
    store = DeepMappingStore.build(copy(Table), DeepMappingConfig(shared=tuple(shared),
                                                                  private=tuple(private)),
                                   spec=spec, params=params_from_numpy(params, "cpu"),
                                   device="cpu")
    return jstore, store, params


def assert_values_equal(got, want, exists=None):
    """Same column set, dtypes and bytes (on ``exists`` rows if given)."""
    assert set(got) == set(want)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if exists is not None:
            g, w = g[exists], w[exists]
        assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), c


def cluster_pair(table, path, shared=(64,), private=(16,), epochs=15, num_shards=3,
                 policy="range"):
    """A cluster built and saved by the reference, and the port's copy
    opened from that save on the CPU (each package's T_aux is the one
    the reference found; two trained builds would give two models).
    ``path`` is where the reference saves it.  Returns ``(reference
    cluster, port cluster)``."""
    import repro_torch
    from repro.cluster import ClusterConfig as JClusterConfig
    from repro.cluster import ShardedDeepMappingStore as JSharded
    from repro.core import DeepMappingConfig as JConfig
    from repro.core import Table as JTable
    from repro.core.trainer import TrainConfig

    jtable = JTable(keys=table.keys.copy(),
                    columns={c: v.copy() for c, v in table.columns.items()})
    jcluster = JSharded.build(
        jtable, JConfig(shared=tuple(shared), private=tuple(private),
                        train=TrainConfig(epochs=epochs, batch_size=512)),
        JClusterConfig(num_shards=num_shards, policy=policy))
    jcluster.save(str(path))
    return jcluster, repro_torch.open(str(path), device="cpu")
