"""The port's DocID build (quantize/, models/ripor.py's installers,
data/emb_store.py, pipeline/recipe.py's index stages) against the JAX
package, on the CPU.

Random draws differ between the packages (torch generators where JAX
takes keys), so parity runs through seams: the JAX package's k-means++
centroids feed both packages' Lloyd iterations, its codebooks feed both
encoders. ``train_rq``/``train_pq`` as a whole are held to
tests/test_quantize.py's properties. Tolerances: assignments and codes
equal (on data whose best and second distances are more than 1e-3 apart
relative, so f32 sums in another order cannot swap them); centroids rtol
1e-5 / atol 1e-6 (f32 cluster sums in another order); decode exact."""
import json

import jax
import numpy as np
import pytest
import torch

from ripor_tpu.data import emb_store as jax_store
from ripor_tpu.models import RiporModel as JaxRiporModel
from ripor_tpu.models import install_codebooks as jax_install_codebooks
from ripor_tpu.models.ripor import install_start_embed as jax_install_start
from ripor_tpu.pipeline import recipe as jax_recipe
from ripor_tpu.quantize import kmeans as jax_kmeans
from ripor_tpu.quantize import pq as jax_pq
from ripor_tpu.quantize import rq as jax_rq
from ripor_tpu_torch.data import emb_store
from ripor_tpu_torch.models import (RiporModel, install_codebooks,
                                    install_start_embed)
from ripor_tpu_torch.pipeline import recipe
from ripor_tpu_torch.quantize import kmeans, pq, rq
from torch_parity import port_state_dict, setup

CPU = "cpu"


def gaussian_mixture(n, k, d, scale=0.05, seed=0):
    """tests/test_quantize.py's data."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32)
    assign = rng.integers(0, k, n)
    x = centers[assign] + scale * rng.standard_normal((n, d)).astype(
        np.float32)
    return x.astype(np.float32), centers, assign


def clear_margin(x, c, rel=1e-3):
    """Rows of x whose best and second squared distances to c are more
    than ``rel`` apart, relative."""
    d2 = ((x[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) > rel * np.maximum(two[:, 0], 1e-12)


def test_assign_codes_equal():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    c = rng.standard_normal((12, 16)).astype(np.float32)
    keep = clear_margin(x, c)
    assert keep.mean() > 0.9
    want = np.asarray(jax_kmeans.assign_codes(x, c))
    got = kmeans.assign_codes(torch.tensor(x), torch.tensor(c)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[keep], want[keep])


def test_lloyd_iterations_from_jax_init():
    x, _, _ = gaussian_mixture(1500, 8, 16, scale=0.3, seed=1)
    key = jax.random.PRNGKey(3)
    xj = jax.numpy.asarray(x)
    c0 = np.asarray(jax_kmeans._kmeanspp_init(xj, 8, key))
    want_c, got_c = c0, torch.tensor(c0)
    g = torch.Generator().manual_seed(0)
    for step_key in jax.random.split(key, 6):
        want_c, want_a = jax_kmeans._lloyd_step(xj, want_c, step_key)
        got_c, got_a = kmeans._lloyd_step(torch.tensor(x), got_c, g)
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
        # no cluster went empty, so no re-seed draw was taken
        assert np.bincount(np.asarray(want_a), minlength=8).min() > 0
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   rtol=1e-5, atol=1e-6)


def test_lloyd_reseeds_empty_clusters():
    x = np.random.default_rng(2).standard_normal((100, 4)).astype(np.float32)
    c = np.concatenate([x[:3], np.full((1, 4), 1e3, np.float32)])
    new, _ = kmeans._lloyd_step(torch.tensor(x), torch.tensor(c),
                                torch.Generator().manual_seed(0))
    # the far centroid owned no row: it is re-seeded onto a data row
    assert any(np.array_equal(new[3].numpy(), r) for r in x)


def _jax_books(seed=0, n=800, d=16, M=4, K=8):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    books = jax_rq.train_rq(x, M=M, K=K, kmeans_iters=8)
    return x, books


@pytest.mark.parametrize("beam", [1, 4])
def test_rq_beam_encode_on_jax_codebooks(beam):
    x, books = _jax_books()
    want_codes, want_err = jax_rq._rq_beam_encode(
        jax.numpy.asarray(x), jax.numpy.asarray(books.codebooks), beam)
    codes, err = rq._rq_beam_encode(torch.tensor(x),
                                    torch.tensor(books.codebooks), beam)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_allclose(err.numpy(), np.asarray(want_err), rtol=1e-5)
    # blocked encode (a ragged last block) equals the JAX package's
    np.testing.assert_array_equal(
        rq.rq_encode(books.codebooks, x, beam=beam, block=300, device=CPU),
        jax_rq.rq_encode(books, x, beam=beam, block=300))


def test_rq_decode_and_pq_exact():
    x, books = _jax_books(seed=1)
    codes = jax_rq.rq_encode(books, x)
    np.testing.assert_array_equal(rq.rq_decode(books.codebooks, codes),
                                  jax_rq.rq_decode(books, codes))
    pbooks = jax_pq.train_pq(x, M=4, K=8, kmeans_iters=6)
    want = jax_pq.pq_encode(pbooks, x)
    got = pq.pq_encode(pq.PQCodebooks(pbooks.codebooks), x, device=CPU)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pq.pq_decode(pbooks.codebooks, want),
                                  jax_pq.pq_decode(pbooks, want))


# ---- train_rq / train_pq: tests/test_quantize.py's properties ----

def test_kmeans_recovers_centroids():
    x, centers, _ = gaussian_mixture(2000, 8, 16)
    fit, assign = kmeans.kmeans_fit(torch.tensor(x), 8, iters=25,
                                    generator=torch.Generator().manual_seed(0))
    fit = fit.numpy()
    d = np.linalg.norm(centers[:, None] - fit[None], axis=-1).min(axis=1)
    assert d.max() < 0.2, d
    manual = np.linalg.norm(x[:, None] - fit[None], axis=-1).argmin(1)
    assert (assign.numpy() == manual).mean() > 0.999


def test_rq_reconstruction_improves_with_stages():
    x = np.random.default_rng(1).standard_normal((3000, 32)).astype(
        np.float32)
    errs = [rq.reconstruction_mse(
        rq.train_rq(x, M=M, K=16, kmeans_iters=15, device=CPU), x, beam=1,
        device=CPU) for M in (1, 2, 4)]
    assert errs[0] > errs[1] > errs[2], errs


def test_rq_beam_no_worse_than_greedy():
    x = np.random.default_rng(2).standard_normal((1000, 16)).astype(
        np.float32)
    books = rq.train_rq(x, M=4, K=8, kmeans_iters=15, device=CPU)
    greedy = rq.reconstruction_mse(books, x, beam=1, device=CPU)
    beamed = rq.reconstruction_mse(books, x, beam=4, device=CPU)
    assert beamed <= greedy * 1.0001, (beamed, greedy)


def test_rq_encode_decode_shapes_and_range():
    x = np.random.default_rng(3).standard_normal((500, 24)).astype(
        np.float32)
    books = rq.train_rq(x, M=6, K=16, kmeans_iters=10, device=CPU)
    assert books.codebooks.shape == (6, 16, 24)
    assert books.codebooks.dtype == np.float32
    codes = rq.rq_encode(books, x, beam=2, device=CPU)
    assert codes.shape == (500, 6) and codes.dtype == np.int32
    assert codes.min() >= 0 and codes.max() < 16
    assert rq.rq_decode(books, codes).shape == x.shape


def test_train_rq_streamed_readonly_memmap(tmp_path):
    n, d = 400, 8
    x = np.random.default_rng(4).normal(size=(n, d)).astype(np.float32)
    path = tmp_path / "embs.mmap"
    mm = np.memmap(path, np.float32, "w+", shape=(n, d))
    mm[:] = x
    mm.flush()
    ro = np.memmap(path, np.float32, "r").reshape(n, d)
    full = rq.train_rq(x, M=2, K=4, kmeans_iters=5, device=CPU)
    streamed = rq.train_rq(ro, M=2, K=4, kmeans_iters=5, batch=128,
                           device=CPU)
    m_full = rq.reconstruction_mse(full, x, device=CPU)
    m_streamed = rq.reconstruction_mse(streamed, x, device=CPU)
    assert m_streamed < m_full * 1.5 + 0.5, (m_full, m_streamed)
    np.testing.assert_array_equal(np.asarray(ro), x)     # input untouched


def test_train_pq_properties():
    x, _, _ = gaussian_mixture(1200, 6, 16, scale=0.1, seed=5)
    books = pq.train_pq(x, M=4, K=8, kmeans_iters=10, device=CPU)
    assert books.codebooks.shape == (4, 8, 4)
    codes = pq.pq_encode(books, x, device=CPU)
    assert codes.shape == (1200, 4) and 0 <= codes.min() <= codes.max() < 8
    recon = pq.pq_decode(books, codes)
    assert recon.shape == x.shape
    mse = np.mean(np.sum((x - recon) ** 2, axis=-1))
    assert mse < 0.1 * np.mean(np.sum((x - x.mean(0)) ** 2, axis=-1)), mse


def test_train_rq_is_reproducible_from_its_generator():
    x = np.random.default_rng(6).standard_normal((300, 8)).astype(np.float32)
    a, b = (rq.train_rq(x, M=2, K=4, kmeans_iters=4, device=CPU,
                        generator=torch.Generator().manual_seed(7))
            for _ in range(2))
    np.testing.assert_array_equal(a.codebooks, b.codebooks)


# ---- installing codebooks into the model ----

def test_install_codebooks_and_start_embed_match_jax():
    cfg, params, *_ = setup(M=4, K=8)
    rng = np.random.default_rng(8)
    books = rng.standard_normal((4, 8, cfg.t5.d_model)).astype(np.float32)
    start = rng.standard_normal(cfg.t5.d_model).astype(np.float32)
    want = jax_install_start(jax_install_codebooks(params, books), start)
    want_sd = port_state_dict(want, cfg)
    got = install_start_embed(install_codebooks(
        port_state_dict(params, cfg), books), start)
    assert set(got) == set(want_sd)
    for k in want_sd:
        assert torch.equal(got[k], want_sd[k]), k
    # a model is written in place, in its dtype
    model = RiporModel(cfg, dtype=torch.bfloat16, device=CPU)
    model.load_state_dict(port_state_dict(params, cfg))
    assert install_codebooks(model, books) is model
    assert torch.equal(model.codebooks,
                       torch.tensor(books).to(torch.bfloat16))
    with pytest.raises(ValueError):
        install_codebooks(model, books[:2])


def test_install_codebooks_unshared_output():
    import dataclasses
    from ripor_tpu.models import ripor_small as jax_ripor_small

    cfg = dataclasses.replace(jax_ripor_small(M=4, K=8),
                              shared_output_input_embeds=False)
    ids = jax.numpy.ones((1, 4), jax.numpy.int32)
    params = JaxRiporModel(cfg).init(
        {"params": jax.random.PRNGKey(0)}, ids, ids,
        jax.numpy.zeros((1, 4), jax.numpy.int32))["params"]
    books = np.random.default_rng(9).standard_normal(
        (4, 8, cfg.t5.d_model)).astype(np.float32)
    want = port_state_dict(jax_install_codebooks(params, books, False), cfg)
    got = install_codebooks(port_state_dict(params, cfg), books, False)
    for k in ("codebooks", "output_codebooks"):
        assert torch.equal(got[k], want[k]), k


# ---- the embedding store ----

def _write_shards(store, out, rng, rank, n):
    w = store.ShardWriter(out, rank=rank, chunk_size=7)
    for s in range(0, n, 5):
        m = min(5, n - s)
        w.add(rng.standard_normal((m, 6)).astype(np.float32),
              [f"r{rank}d{s + i}" for i in range(m)])
    return w.finalize()


@pytest.mark.parametrize("writer,reader", [(jax_store, emb_store),
                                           (emb_store, jax_store)])
def test_emb_store_files_cross_read(tmp_path, writer, reader):
    rng = np.random.default_rng(10)
    out = tmp_path / "embs"
    assert _write_shards(writer, out, rng, 0, 12) == 2
    assert _write_shards(writer, out, rng, 1, 9) == 2
    assert (writer.write_plan(out, 2)
            == reader.write_plan(tmp_path / "embs", 2))
    a = list(writer.iter_shards(out))
    b = list(reader.iter_shards(out))
    assert len(a) == len(b) == 4
    for (ea, ia), (eb, ib) in zip(a, b):
        np.testing.assert_array_equal(ea, eb)
        np.testing.assert_array_equal(ia, ib)
    p1, n1 = writer.merge_to_mmap(out, tmp_path / "m1")
    p2, n2 = reader.merge_to_mmap(out, tmp_path / "m2")
    assert n1 == n2 == 21
    for name in ("doc_embeds.mmap", "text_ids.tsv", "meta.json"):
        assert ((tmp_path / "m1" / name).read_bytes()
                == (tmp_path / "m2" / name).read_bytes()), name
    arr, ids = reader.open_mmap(tmp_path / "m1")
    want_arr, want_ids = writer.open_mmap(tmp_path / "m1")
    np.testing.assert_array_equal(arr, want_arr)
    assert ids == want_ids and ids[0] == "r0d0" and ids[-1] == "r1d8"
    for r in range(3):
        assert (emb_store.host_shard_slice(21, r, 3)
                == jax_store.host_shard_slice(21, r, 3))


# ---- the recipe's index stages ----

def test_recipe_stage_files(tmp_path):
    from ripor_tpu.data import Collection as JaxCollection
    from ripor_tpu.models import RiporModel as JaxModel
    from ripor_tpu_torch.data.datasets import Collection
    from ripor_tpu_torch.data.datasets import load_docid_to_smtid
    from torch_parity import port_model

    cfg, params, *_ = setup(M=4, K=8)
    docs_dir = tmp_path / "docs"
    docs_dir.mkdir()
    texts = [f"document {i} talks about topic {i % 5}" for i in range(20)]
    (docs_dir / "raw.tsv").write_text(
        "".join(f"d{i}\t{t}\n" for i, t in enumerate(texts)))
    jws = jax_recipe.Workspace(tmp_path / "jax")
    pws = recipe.Workspace(tmp_path / "port")
    jtok = jax_recipe.stage_tokenizer(jws, texts, 200, kind="word")
    ptok = recipe.stage_tokenizer(pws, texts, 200, kind="word")
    assert (jws.path("tokenizer.json").read_bytes()
            == pws.path("tokenizer.json").read_bytes())
    assert recipe.stage_tokenizer(pws, [], 5).vocab_size == ptok.vocab_size

    jembs = jax_recipe.stage_encode_corpus(
        jws, JaxModel(cfg), params, JaxCollection(docs_dir), jtok,
        max_length=16, batch_size=8)
    pembs = recipe.stage_encode_corpus(pws, port_model(params, cfg),
                                       Collection(docs_dir), ptok,
                                       max_length=16, batch_size=8)
    np.testing.assert_allclose(pembs, jembs, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.load(pws.path("doc_embeds.npy")), pembs)
    assert (jws.path("text_ids.tsv").read_bytes()
            == pws.path("text_ids.tsv").read_bytes())

    docids = [f"d{i}" for i in range(20)]
    codes = recipe.stage_build_docids(pws, pembs, docids, M=4, K=8,
                                      kmeans_iters=5, device=CPU)
    jax_recipe.stage_build_docids(jws, jembs, docids, M=4, K=8,
                                  kmeans_iters=5)
    for ws in (jws, pws):
        assert ws.has("codebooks.npy") and ws.has("docid_to_smtid.json")
    jd2s = json.loads(jws.path("docid_to_smtid.json").read_text())
    pd2s = json.loads(pws.path("docid_to_smtid.json").read_text())
    assert list(jd2s) == list(pd2s)
    assert all(v[0] == -1 and len(v) == 5 for v in pd2s.values())
    books = np.load(pws.path("codebooks.npy"))
    assert books.shape == (4, 8, cfg.t5.d_model)
    np.testing.assert_array_equal(
        codes, jax_rq.rq_encode(books, pembs, beam=4))
    read_ids, read_codes = load_docid_to_smtid(pws.path("docid_to_smtid.json"))
    assert read_ids == docids
    np.testing.assert_array_equal(read_codes, codes)
    # a second call reads the files back
    np.testing.assert_array_equal(
        recipe.stage_build_docids(pws, pembs, docids, M=4, K=8), codes)

    got = recipe.stage_install_codebooks(pws, port_state_dict(params, cfg))
    want = port_state_dict(jax_recipe.stage_install_codebooks(jws, params),
                           cfg)
    np.testing.assert_array_equal(got["codebooks"].numpy(), books)
    assert not np.array_equal(want["codebooks"].numpy(), books)
    assert torch.equal(
        recipe.stage_install_codebooks(jws, port_state_dict(params, cfg))
        ["codebooks"], want["codebooks"])
