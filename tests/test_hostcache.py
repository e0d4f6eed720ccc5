"""Host-mirror cache and host-side transform twins.

The orchestration layer must not pay blocking device->host pulls for arrays
it built itself (a profile counted ~170 of them per VBMC iteration).
These tests pin
down the two mechanisms that eliminate them: the id-keyed host mirror
(`utils/hostcache.py`) and the numpy twins of the transform maps
(`transforms.py`, cf. `shared/warpvars_vbmc.m` semantics).
"""

import gc

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vbmc_tpu.utils import hostcache as hc
from vbmc_tpu.transforms import (
    create_trinfo, direct, inverse, log_abs_det_jacobian,
    direct_np, inverse_np, log_abs_det_jacobian_np,
)


class TestHostCache:
    def test_roundtrip_identity(self):
        host = np.arange(12.0).reshape(3, 4)
        dev = hc.device_put_cached(host)
        got = hc.to_np(dev)
        # Served from the mirror: the registered object itself (cast copy
        # allowed when dtypes differ), no device transfer.
        assert np.array_equal(got, np.asarray(dev))

    def test_mirror_matches_pull_after_dtype_cast(self):
        host = np.array([1.0 + 1e-12, np.pi, 1e30])
        dev = hc.device_put_cached(host, dtype=jnp.float32)
        mirrored = hc.to_np(dev)
        pulled = np.asarray(dev)
        assert mirrored.dtype == pulled.dtype
        np.testing.assert_array_equal(mirrored, pulled)

    def test_miss_registers(self):
        dev = jnp.arange(5.0) * 3  # device-computed: no mirror yet
        v1 = hc.to_np(dev)
        v2 = hc.to_np(dev)
        assert v1 is v2  # second read served from the mirror
        np.testing.assert_array_equal(v1, np.asarray(dev))

    def test_eviction_on_gc(self):
        n0 = hc.cache_size()
        dev = hc.device_put_cached(np.ones(7))
        assert hc.cache_size() == n0 + 1
        del dev
        gc.collect()
        assert hc.cache_size() == n0

    def test_reregister(self):
        host = np.ones((2, 3))
        a = hc.device_put_cached(host)
        b = jnp.asarray(host)  # same value, distinct buffer, no mirror
        hc.reregister(b, a)
        assert hc.to_np(b) is hc.to_np(a)

    def test_shape_mismatch_ignored(self):
        dev = jnp.ones((2, 2))
        hc.register(dev, np.ones(3))  # wrong shape: must not poison cache
        np.testing.assert_array_equal(hc.to_np(dev), np.ones((2, 2)))

    def test_non_jax_passthrough(self):
        x = np.ones(3)
        assert hc.to_np(x) is x
        assert hc.register("notanarray", x) == "notanarray"


class TestGPHostMirrors:
    def test_train_gp_serves_passthrough_fields_from_mirror(self):
        from vbmc_tpu.gp.config import GPConfig
        from vbmc_tpu.gp.fit import train_gp, TrainOptions

        rng = np.random.default_rng(0)
        D = 2
        X = rng.standard_normal((12, D))
        y = -0.5 * np.sum(X ** 2, axis=1)
        opts = TrainOptions(ns_samples=0, ninit=0, nopts=1, lbfgs_iters=10)
        cfg = GPConfig(D=D)
        gp, _ = train_gp(jax.random.PRNGKey(0), cfg, X, y, None,
                         np.full(D, -2.0), np.full(D, 2.0), opts,
                         host_seed=7)
        for field in ("X", "y", "s2", "mask", "hyp", "hyp_mask"):
            dev = getattr(gp, field)
            first = hc.to_np(dev)
            assert first is hc.to_np(dev), field
            np.testing.assert_array_equal(first, np.asarray(dev),
                                          err_msg=field)


class TestTransformTwins:
    @pytest.mark.parametrize("bounded_type", [3, 12, 13])
    def test_np_matches_jax(self, bounded_type, rng):
        lb = np.array([-np.inf, 0.0, -np.inf, -2.0])
        ub = np.array([np.inf, np.inf, 3.0, 5.0])
        plb = np.array([-1.0, 0.5, -2.0, -1.5])
        pub = np.array([2.0, 4.0, 2.0, 4.0])
        ti = create_trinfo(lb, ub, plb, pub, bounded_type=bounded_type)
        X = rng.uniform(plb, pub, size=(50, 4))

        Yj = np.asarray(direct(ti, jnp.asarray(X)))
        Yn = direct_np(ti, X)
        np.testing.assert_allclose(Yn, Yj, rtol=1e-12, atol=1e-12)

        Xj = np.asarray(inverse(ti, jnp.asarray(Yj)))
        np.testing.assert_allclose(inverse_np(ti, Yn), Xj,
                                   rtol=1e-12, atol=1e-12)

        Lj = np.asarray(log_abs_det_jacobian(ti, jnp.asarray(Yj)))
        np.testing.assert_allclose(log_abs_det_jacobian_np(ti, Yn), Lj,
                                   rtol=1e-12, atol=1e-12)

    def test_np_matches_jax_rotoscale(self, rng):
        D = 4
        ti = create_trinfo(np.full(D, -2.0), np.full(D, 5.0),
                           np.full(D, -1.0), np.full(D, 4.0))
        R = np.linalg.qr(rng.standard_normal((D, D)))[0]
        s = rng.uniform(0.5, 2.0, D)
        ti = ti._replace(R_mat=jnp.asarray(R), scale=jnp.asarray(s))
        X = rng.uniform(-1.0, 4.0, size=(30, D))
        Yj = np.asarray(direct(ti, jnp.asarray(X)))
        Yn = direct_np(ti, X)
        np.testing.assert_allclose(Yn, Yj, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            inverse_np(ti, Yn),
            np.asarray(inverse(ti, jnp.asarray(Yj))), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            log_abs_det_jacobian_np(ti, Yn),
            np.asarray(log_abs_det_jacobian(ti, jnp.asarray(Yj))),
            rtol=1e-12, atol=1e-12)
