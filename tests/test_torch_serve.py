"""The port's serving tier (``easydl_tpu_torch/serve/``, ``loop/publish.py``)
against the JAX package's, on the same seeded numpy inputs:

- **scorer**: the port's ``make_deepfm_forward(device="cpu")`` against the
  JAX one, given the same flax params, at 1, 3 and 17 rows (across the
  power-of-two bucket padding and past ``max_batch``), with and without
  dense features: f32, relative L2 within ``SCORER_REL``; without a card it
  refuses the card;
- **frontends**: each package's ``ServeFrontend`` on a ``LocalPsClient``
  with the same ``TableSpec``: the same requests, arriving in one order
  while the batch runner is held, give equal ``recent_batches``
  compositions, ``_numpy_forward`` scores bit-equal and DeepFM scores
  within ``SCORER_REL``; the ``Infer`` and ``Rollout`` RPCs answer with
  the same verdicts, a shed past ``max_pending`` among them;
- **publication**: a version published by either package loads through the
  other's ``ModelVersionWatcher``, and rollback, the pin's visibility cap
  and the quarantine of a flipped byte go the same way;
- **the cache**: ``HotIdCache``'s counts, bytes and resident ids match the
  reference's after every operation of one seeded stream of puts, lookups
  and demotions that overflows its byte bound.

The model is small: 4 sparse fields, dim 8, 3 dense features, tower (16,).
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import easydl_tpu.loop.publish as jax_publish  # noqa: E402
import easydl_tpu.ps.client as jax_client  # noqa: E402
import easydl_tpu.ps.read_client as jax_read_client  # noqa: E402
import easydl_tpu.ps.table as jax_table  # noqa: E402
import easydl_tpu.serve as jax_serve  # noqa: E402
import easydl_tpu.serve.cache as jax_cache  # noqa: E402
import easydl_tpu.serve.frontend as jax_frontend  # noqa: E402
import easydl_tpu_torch.loop.publish as pt_publish  # noqa: E402
import easydl_tpu_torch.ps.client as pt_client  # noqa: E402
import easydl_tpu_torch.ps.read_client as pt_read_client  # noqa: E402
import easydl_tpu_torch.ps.table as pt_table  # noqa: E402
import easydl_tpu_torch.serve as pt_serve  # noqa: E402
import easydl_tpu_torch.serve.cache as pt_cache  # noqa: E402
import easydl_tpu_torch.serve.frontend as pt_frontend  # noqa: E402
from easydl_tpu.proto import easydl_pb2 as pb  # noqa: E402
from easydl_tpu.utils.rpc import GRPC_MSG_OPTIONS, RpcClient  # noqa: E402

FIELDS, DIM, DENSE, HIDDEN = 4, 8, 3, (16,)
MAX_BATCH = 16
#: f32 end to end; the CPU reads 5e-8 to 5e-7 (XLA's and torch's sums)
SCORER_REL = 1e-5

PACKAGES = {
    "jax": (jax_client, jax_read_client, jax_table, jax_serve, jax_frontend),
    "port": (pt_client, pt_read_client, pt_table, pt_serve, pt_frontend),
}


def jax_params(dense_dim: int = DENSE, seed: int = 1) -> dict:
    """The flax DeepFMDense tree (unboxed numpy), the wide kernel drawn
    (it is zero at init)."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from easydl_tpu.models.deepfm import DeepFMDense

    params = DeepFMDense(hidden=HIDDEN).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, FIELDS, DIM)),
        jnp.zeros((1, max(dense_dim, 1))))["params"]
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    rng = np.random.default_rng(seed)
    params["wide"]["kernel"] = (0.1 * rng.standard_normal(params["wide"]["kernel"].shape)
                                ).astype(np.float32)
    return params


def forwards(params: dict, dense_dim: int = DENSE) -> dict:
    return {"jax": jax_frontend.make_deepfm_forward(FIELDS, DIM, dense_dim, hidden=HIDDEN,
                                                    max_batch=MAX_BATCH, params=params),
            "port": pt_frontend.make_deepfm_forward(FIELDS, DIM, dense_dim, hidden=HIDDEN,
                                                    max_batch=MAX_BATCH, params=params,
                                                    device="cpu")}


def rel(a, b) -> float:
    return float(np.linalg.norm(a.astype(np.float64) - b) / np.linalg.norm(b))


# ------------------------------------------------------------------ scorer
@pytest.mark.parametrize("dense_dim", [DENSE, 0])
@pytest.mark.parametrize("rows", [1, 3, 17])
def test_the_scorer_matches_the_jax_one(rows, dense_dim):
    fwd = forwards(jax_params(dense_dim), dense_dim)
    rng = np.random.default_rng(rows)
    emb = (0.5 * rng.standard_normal((rows, FIELDS, DIM))).astype(np.float32)
    dense = rng.standard_normal((rows, dense_dim)).astype(np.float32)
    got, want = fwd["port"](emb, dense), np.asarray(fwd["jax"](emb, dense))
    assert got.shape == want.shape == (rows,) and got.dtype == np.float32
    assert rel(got, want) <= SCORER_REL


def test_the_scorer_inits_from_its_seed_and_refuses_a_missing_card():
    """Without params two builds of one seed score alike, another seed
    differently; the card is the default device."""
    a, b, c = (pt_frontend.make_deepfm_forward(FIELDS, DIM, DENSE, hidden=HIDDEN, seed=s,
                                               device="cpu") for s in (0, 0, 1))
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((5, FIELDS, DIM)).astype(np.float32)
    dense = rng.standard_normal((5, DENSE)).astype(np.float32)
    assert np.array_equal(a(emb, dense), b(emb, dense))
    assert not np.allclose(a(emb, dense), c(emb, dense))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            pt_frontend.make_deepfm_forward(FIELDS, DIM, DENSE)


# --------------------------------------------------------------- frontends
def frontend(pkg: str, forward=None, **config):
    client, read_client, table, serve, _ = PACKAGES[pkg]
    ps = client.LocalPsClient(num_shards=2)
    ps.create_table(table.TableSpec(name="emb", dim=DIM, optimizer="sgd", lr=0.1, seed=3))
    reads = read_client.PsReadClient(ps, cache=serve.HotIdCache(1 << 20))
    config = {"table": "emb", "fields": FIELDS, "dense_dim": DENSE, **config}
    return serve.ServeFrontend(reads, serve.ServeConfig(**config), forward=forward,
                               name=f"{pkg}-0")


def requests(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows = 1 + i % 3
        out.append((rng.integers(0, 2**40, (rows, FIELDS), dtype=np.int64),
                    rng.standard_normal((rows, DENSE)).astype(np.float32)))
    return out


def enqueued(fe, n: int) -> None:
    """Waits until ``fe`` has admitted ``n`` requests and its batch runner
    has taken the first (which then waits at the gate)."""
    deadline = time.monotonic() + 10
    while (fe._seq < n or fe._queue and fe._queue[0].seq == 1) \
            and time.monotonic() < deadline:
        time.sleep(0.001)


def held_run(fe, gate, reqs) -> list:
    """``reqs`` sent one after another while the batch runner holds its
    first batch at ``gate``; returns the results in request order."""
    results = [None] * len(reqs)

    def one(i):
        results[i] = fe.infer(*reqs[i])

    threads = []
    for i in range(len(reqs)):
        threads.append(threading.Thread(target=one, args=(i,)))
        threads[-1].start()
        enqueued(fe, i + 1)  # arrival order is request order
    gate.set()
    for t in threads:
        t.join(timeout=30)
    return results


def gated(inner, gate):
    def forward(emb, dense):
        gate.wait(10)
        return inner(emb, dense)
    return forward


@pytest.mark.parametrize("scorer", ["numpy", "deepfm"])
def test_frontends_batch_and_score_alike(scorer):
    params = jax_params()
    inner = ({"jax": jax_frontend._numpy_forward, "port": pt_frontend._numpy_forward}
             if scorer == "numpy" else forwards(params))
    reqs = requests(8)
    seen = {}
    for pkg in PACKAGES:
        gate = threading.Event()
        fe = frontend(pkg, gated(inner[pkg], gate), max_batch=4, max_wait_ms=1.0)
        try:
            results = held_run(fe, gate, reqs)
            seen[pkg] = (list(fe.recent_batches), results)
        finally:
            gate.set()
            fe.stop()
    assert seen["jax"][0] == seen["port"][0]
    assert len(seen["port"][0]) > 2 and max(map(len, seen["port"][0])) > 1
    for want, got in zip(seen["jax"][1], seen["port"][1]):
        assert want.ok and got.ok
        if scorer == "numpy":
            assert np.array_equal(got.scores, want.scores)
        else:
            assert rel(got.scores, np.asarray(want.scores)) <= SCORER_REL


def rpc_verdicts(pkg: str) -> list:
    """The Infer and Rollout RPCs' answers, over gRPC, to malformed and
    sound requests and to one past the admission bound while the runner is
    held."""
    gate = threading.Event()
    fe = frontend(pkg, gated(PACKAGES[pkg][4]._numpy_forward, gate), max_batch=2,
                  max_wait_ms=1.0, max_pending=4)
    server = fe.serve()
    rpc = RpcClient(jax_frontend.SERVE_SERVICE, server.address, timeout=30.0,
                    options=GRPC_MSG_OPTIONS)
    ids = np.arange(2 * FIELDS, dtype=np.int64)

    def infer(**kw):
        r = rpc.Infer(pb.InferRequest(**kw))
        return (r.ok, r.verdict, np.frombuffer(r.scores, "<f4").tolist())

    try:
        out = [infer(raw_ids=ids[:5].astype("<i8").tobytes(), fields=FIELDS),
               infer(raw_ids=b"\0" * 12, fields=FIELDS),
               infer(raw_ids=ids.astype("<i8").tobytes(), fields=FIELDS, dense_dim=DENSE + 1),
               infer(raw_ids=ids.astype("<i8").tobytes(), fields=FIELDS, dense=b"\0" * 4),
               infer(raw_ids=np.arange(5 * FIELDS).astype("<i8").tobytes(), fields=FIELDS)]
        held = []  # one batch in the forward, two requests queued: 4 rows pending
        threads = [threading.Thread(target=lambda: held.append(fe.infer(ids.reshape(2, -1))))
                   for _ in range(3)]
        for i, t in enumerate(threads):
            t.start()
            enqueued(fe, i + 1)
        out.append(infer(raw_ids=ids[:FIELDS].astype("<i8").tobytes(), fields=FIELDS))
        gate.set()
        for t in threads:
            t.join(timeout=30)
        out.append(sorted((r.ok, r.verdict) for r in held))
        out.append(infer(raw_ids=ids.astype("<i8").tobytes(), fields=FIELDS,
                         dense=np.ones((2, DENSE), "<f4").tobytes(), dense_dim=DENSE))
        for action in ("status", "rollback", "clear", "bogus"):
            r = rpc.Rollout(pb.RolloutRequest(action=action))
            out.append((r.ok, r.message, r.active_version, r.canary_version, r.swaps))
    finally:
        gate.set()
        rpc.close()
        fe.stop()
    return out


def test_the_rpcs_answer_alike():
    jax_answers, port_answers = rpc_verdicts("jax"), rpc_verdicts("port")
    assert port_answers == jax_answers
    shed = port_answers[5]
    assert not shed[0] and shed[1].startswith(jax_frontend.OVERLOADED)
    assert port_answers[-5][0]  # the sound request scored


# ------------------------------------------------------------- publication
PUBLISH = {"jax": jax_publish, "port": pt_publish}


def rollout_story(publisher, reader, models: str) -> list:
    """v1 and v2 published by ``publisher`` and adopted by ``reader``'s
    watcher, rolled back, v3 published with one byte flipped, the pin
    cleared; returns what each step showed."""
    swaps, loaded = [], []

    def loader(manifest, arrays):
        loaded.append((manifest["version"], float(arrays["w"].sum())))
        return lambda emb, dense: np.zeros(len(emb), np.float32)

    watcher = reader.ModelVersionWatcher(models, loader, on_swap=lambda v, f: swaps.append(v),
                                         replica="story", poll_s=3600)
    out = []
    for w in (1.0, 2.0):
        publisher.publish_version(models, {"w": np.full(3, w, np.float32)}, keep=8)
    out.append(("adopt", watcher.poll_once(), watcher.current))
    out.append(("rollback", watcher.rollback(), publisher.read_rollback(models),
                publisher.active_version(models)))
    v3 = publisher.publish_version(models, {"w": np.full(3, 3.0, np.float32)}, keep=8)
    out.append(("pinned", watcher.poll_once(), reader.list_versions(models)))
    path = os.path.join(models, f"v_{v3:08d}", "w.npy")
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF
    open(path, "wb").write(bytes(data))
    reader.clear_rollback(models)
    out.append(("clear", watcher.poll_once(), watcher.current, watcher.quarantined,
                publisher.list_versions(models),
                os.path.exists(os.path.join(models, f"v_{v3:08d}", "CORRUPT"))))
    out.append(("bank", swaps, loaded))
    return out


@pytest.mark.parametrize("publisher,reader", [("jax", "port"), ("port", "jax")])
def test_a_version_published_by_one_package_loads_in_the_other(publisher, reader, tmp_path):
    across = rollout_story(PUBLISH[publisher], PUBLISH[reader], str(tmp_path / "across"))
    alone = rollout_story(PUBLISH[reader], PUBLISH[reader], str(tmp_path / "alone"))
    assert across == alone
    assert across[0][1:] == (2, 2)
    assert across[1][1:] == ((True, "active version 1"), 1, 1)
    assert across[3][1:] == (2, 2, [3], [1, 2], True)
    assert across[4][2] == [(2, 6.0), (1, 3.0)]  # v3 never built


# ------------------------------------------------------------------ cache
def test_the_cache_evicts_as_the_reference_does():
    """Resident ids are read from the table's index (a lookup would move
    them up the LRU order)."""
    row_cost = DIM * 4 + jax_cache.ENTRY_OVERHEAD_BYTES
    assert pt_cache.ENTRY_OVERHEAD_BYTES == jax_cache.ENTRY_OVERHEAD_BYTES
    caches = {"jax": jax_cache.HotIdCache(max_bytes=40 * row_cost),
              "port": pt_cache.HotIdCache(max_bytes=40 * row_cost)}
    rng = np.random.default_rng(7)
    for step in range(300):
        kind = rng.integers(0, 4)
        ids = np.unique(rng.zipf(1.3, rng.integers(1, 24)) % 96).astype(np.int64)
        rows = rng.standard_normal((len(ids), DIM)).astype(np.float32)
        shards = rng.integers(0, 2, len(ids)).astype(np.int32)
        versions = rng.integers(1, 4, len(ids)).astype(np.uint64)
        state = {}
        for name, cache in caches.items():
            cache.set_generation(0 if step < 250 else 1)
            if kind < 2:
                slots, got_shards, got_versions = cache.lookup("emb", ids)
                hit = slots >= 0
                seen = (slots.tolist(), got_shards.tolist(), got_versions.tolist(),
                        cache.gather("emb", slots[hit]).tolist() if hit.any() else [])
                if kind == 0 and hit.any():  # a version-rejected hit
                    cache.demote("emb", ids[hit][:1], slots[hit][:1])
            else:
                cache.put("emb", ids, rows, shards, versions)
                seen = None
            table = cache._tables.get("emb")
            state[name] = (seen, cache.stats(),
                           sorted(table.index.items()) if table is not None else [])
        assert state["port"] == state["jax"], step
    stats = state["port"][1]
    assert stats["evictions"] > 0 and stats["invalidations"] > 0 and stats["hits"] > 0
