"""The port's collectives (``repro_torch.runtime.collectives``) against the
JAX package's, which run once, in one subprocess with 4 forced host
devices (``tests/test_collectives.py``'s setup; the main process keeps one
device).

``compressed_psum`` over 24 steps of error feedback: every step's reduced
sum and every shard's new error bit-equal to JAX's, and JAX's bounds (a
step within P shared scales of the exact sum, the accumulated sum within
twice that).
``collective_matmul_ag``: equal to the plain matmul of the gathered rows,
bit for bit in the port (each row block one torch matmul either way) and
to JAX's within fp32 rounding (rtol 1e-6: XLA's CPU dot and torch's sum in
different orders). ``all_reduce_sum`` adds in shard order."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.runtime import collectives as coll  # noqa: E402

P, T, D = 4, 24, 64
SHAPES = [(8, 16, 12), (4, 32, 32)]

_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.runtime import collectives as coll
from repro.sharding import compat

data = np.load(sys.argv[1])
mesh = compat.make_mesh((4,), ("model",))
out = {}
psum = compat.shard_map(
    lambda xs, es: coll.compressed_psum(xs, "model", es),
    mesh, in_specs=(P("model", None), P("model", None)),
    out_specs=(P(None, None), P("model", None)))
err = jnp.zeros((4, %(D)d), jnp.float32)
for t in range(%(T)d):
    tot, err = psum(jnp.asarray(data[f"psum_x{t}"]), err)
    out[f"psum_total{t}"] = np.asarray(tot)
    out[f"psum_err{t}"] = np.asarray(err)
for i in range(%(n)d):
    fn = compat.shard_map_unchecked(
        lambda xs, ws: coll.collective_matmul_ag(xs, ws, "model"),
        mesh, in_specs=(P("model", None), P(None, None)),
        out_specs=P(None, None))
    out[f"cm{i}"] = np.asarray(fn(jnp.asarray(data[f"cm_x{i}"]),
                                  jnp.asarray(data[f"cm_w{i}"])))
np.savez(sys.argv[2], **out)
print("JAX-COLLECTIVES-OK")
""" % {"D": D, "T": T, "n": len(SHAPES)}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Inputs from numpy seeds, JAX's outputs from one subprocess."""
    tmp = tmp_path_factory.mktemp("coll")
    rng = np.random.default_rng(3)
    data = {}
    for t in range(T):
        # each step: one (1, D) row per shard, with a spread of scales
        data[f"psum_x{t}"] = (rng.standard_normal((P, D))
                              * (1 + 3 * rng.random((P, 1)))
                              ).astype(np.float32)
    for i, (rows, K, N) in enumerate(SHAPES):
        data[f"cm_x{i}"] = rng.standard_normal((rows * P, K)).astype(
            np.float32)
        data[f"cm_w{i}"] = rng.standard_normal((K, N)).astype(np.float32)
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **data)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX, str(src), str(dst)],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
    assert "JAX-COLLECTIVES-OK" in r.stdout, r.stdout + r.stderr
    return data, dict(np.load(dst))


def test_compressed_psum_matches_jax(jax_run):
    """Every step bit-equal to JAX's; each step within P·max_scale of the
    exact sum (the fresh and the fed-back residuals), and the accumulated
    drift within twice that (JAX's bounds)."""
    data, want = jax_run
    errors = [torch.zeros(D) for _ in range(P)]
    acc_q = np.zeros(D, np.float64)
    acc_f = np.zeros(D, np.float64)
    max_amax = 0.0
    for t in range(T):
        xs = [torch.tensor(row) for row in data[f"psum_x{t}"]]
        amax = float(max((x + e).abs().max() for x, e in zip(xs, errors)))
        totals, errors = coll.compressed_psum(xs, errors)
        assert all(torch.equal(x, totals[0]) for x in totals)
        assert np.array_equal(totals[0].numpy(), want[f"psum_total{t}"][0])
        assert np.array_equal(torch.stack(errors).numpy(),
                              want[f"psum_err{t}"])
        exact = data[f"psum_x{t}"].sum(0)
        max_amax = max(max_amax, amax)
        assert np.abs(totals[0].numpy() - exact).max() <= \
            P * (max_amax / 127.0) + 1e-5
        acc_q += totals[0].numpy()
        acc_f += exact
    assert np.abs(acc_q - acc_f).max() <= 2.0 * P * (max_amax / 127.0) + 1e-5


def test_quantize_int8_roundtrip():
    x = torch.tensor(np.random.default_rng(0).standard_normal(256),
                     dtype=torch.float32)
    q, scale = coll.quantize_int8(x)
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    assert float((coll.dequantize_int8(q, scale) - x).abs().max()) <= \
        float(scale) / 2 + 1e-7


def test_collective_matmul_ag_matches_plain_and_jax(jax_run):
    data, want = jax_run
    for i in range(len(SHAPES)):
        x = torch.tensor(data[f"cm_x{i}"])
        w = torch.tensor(data[f"cm_w{i}"])
        outs = coll.collective_matmul_ag(list(x.chunk(P)), [w] * P)
        plain = torch.cat([torch.matmul(b, w) for b in x.chunk(P)])
        for o in outs:
            assert torch.equal(o, plain)
        np.testing.assert_allclose(outs[0].numpy(), want[f"cm{i}"],
                                   rtol=1e-6, atol=1e-6)


def test_all_reduce_sum_in_shard_order():
    """fp32 sums depend on their order: shard 0, then 1, then 2."""
    parts = [torch.tensor([1e8, 3.0]), torch.tensor([1.0, 1e8]),
             torch.tensor([-1e8, -1e8])]
    got = coll.all_reduce_sum(parts, torch.device("cpu"))
    assert got.tolist() == ((parts[0] + parts[1]) + parts[2]).tolist() \
        == [0.0, 0.0]
    assert ((parts[0] + parts[2]) + parts[1]).tolist() == [1.0, 0.0]
