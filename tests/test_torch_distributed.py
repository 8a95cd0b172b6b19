"""The deprecated mesh drivers of the port (core/distributed.py) against
``corr(mesh=)`` and the reference, on CPU meshes.

Each wrapper warns once a call (a DeprecationWarning naming corr(),
pointing at the caller) and is bitwise ``corr(x, mesh=mesh[, shard_u=True])``
of the port; against the reference's wrapper the values agree within
3e-6 (the same products summed in other orders).  The reference's mesh
scatter fails on this tree (ROADMAP C2), so its single-device ``corr``,
which its design makes its wrappers' result, is the oracle.  The
counterpart of tests/test_api.py's legacy-wrapper test.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as ref_distributed
from repro.core.api import corr as ref_corr
from repro_torch.core import distributed
from repro_torch.core.api import corr
from repro_torch.core.plan import tiles_per_device
from repro_torch.core.sinks import HostSink, TopKSink
from repro_torch.launch.mesh import make_mesh

ATOL = 3e-6
KW = dict(t=8, l_blk=8, device="cpu")


def _x(n, l, seed=0):
    return np.random.default_rng(seed).normal(size=(n, l)).astype(np.float32)


def _one_warning(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1, [str(w.message) for w in rec]
    assert "corr(" in str(dep[0].message)
    assert dep[0].filename == __file__     # stacklevel=3: the caller
    return out


@pytest.mark.parametrize("shape,axes", [((4,), ("d",)),
                                        ((2, 2), ("a", "b")),
                                        ((8,), ("d",))])
@pytest.mark.parametrize("name", ["allpairs_pcc_sharded",
                                  "allpairs_pcc_sharded_u"])
def test_legacy_sharded_wrappers_warn_once_and_are_corr(name, shape, axes):
    x = _x(50, 37, seed=1)
    mesh = make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))
    fn = getattr(distributed, name)
    shard_u = name.endswith("_u")
    for mtp in (None, 2):
        got = _one_warning(lambda: fn(x, mesh, max_tiles_per_pass=mtp, **KW))
        assert torch.equal(got, corr(x, mesh=mesh, shard_u=shard_u,
                                     max_tiles_per_pass=mtp, **KW))
        assert torch.equal(got, corr(x, max_tiles_per_pass=mtp, **KW))
    # the reference's wrappers fail on its mesh scatter on this tree
    # (ROADMAP C2); its single-device corr is what its design makes them
    want = np.asarray(ref_corr(jnp.asarray(x), t=8, l_blk=8))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_legacy_sharded_wrappers_take_measures_dtypes_and_sinks():
    x = _x(40, 20, seed=2)
    mesh = make_mesh((4,), ("d",), devices=["cpu"] * 4)
    for fn, shard_u in ((distributed.allpairs_pcc_sharded, False),
                        (distributed.allpairs_pcc_sharded_u, True)):
        for kw in (dict(measure="spearman"),
                   dict(measure="kendall", compute_dtype="int8"),
                   dict(measure="cosine", fuse_epilogue=False)):
            got = _one_warning(lambda: fn(x, mesh, **kw, **KW))
            assert torch.equal(got, corr(x, mesh=mesh, shard_u=shard_u,
                                         **kw, **KW))
        top = _one_warning(lambda: fn(x, mesh, sink=TopKSink(3), **KW))
        want = corr(x, sink=TopKSink(3), **KW)
        np.testing.assert_array_equal(top["indices"], want["indices"])
        np.testing.assert_array_equal(top["values"], want["values"])
        host = _one_warning(lambda: fn(x, mesh, sink=HostSink(), **KW))
        np.testing.assert_array_equal(host, corr(x, **KW).numpy())


def test_sharded_aliases_and_exports():
    assert distributed.allpairs_sharded is distributed.allpairs_pcc_sharded
    assert distributed.allpairs_sharded_u is \
        distributed.allpairs_pcc_sharded_u
    assert distributed.tiles_per_device is tiles_per_device
    assert sorted(distributed.__all__) == sorted(ref_distributed.__all__)
    from repro_torch import core
    assert core.allpairs_pcc_sharded is distributed.allpairs_pcc_sharded
    assert core.allpairs_pcc_sharded_u is distributed.allpairs_pcc_sharded_u
    for total in (1, 7, 36):
        for p in (1, 3, 8):
            assert tiles_per_device(total, p) == \
                ref_distributed.tiles_per_device(total, p)
