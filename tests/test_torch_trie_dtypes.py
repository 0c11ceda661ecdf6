"""The trie tables' code dtype on the device (trie/succinct.py,
``tables_to_torch``): uint8 up to 256 codes, int16 up to 32,768, int32
above, since CUDA indexes no uint16 tensor; the numpy tables keep the
narrowest unsigned dtype. The ``cuda`` case runs a megarow search at
K = 1,024 on the card against the same search on the CPU:
``python -m pytest -q --noconftest -m cuda tests/test_torch_trie_dtypes.py``
(no JAX is imported here)."""
import numpy as np
import pytest
import torch

from ripor_tpu_torch.decode.beam import make_beam_search_fn
from ripor_tpu_torch.models import RiporModel, init_params, ripor_small
from ripor_tpu_torch.trie import build_trie, succinct_tables, tables_to_torch


def _tables(K, M, docs, seed=0):
    codes = np.random.default_rng(seed).integers(0, K, (docs, M))
    codes[0] = K - 1                    # the largest code is stored
    trie = build_trie(codes, K)
    return trie, succinct_tables(trie)


@pytest.mark.parametrize("K,host,device", [
    (256, np.uint8, torch.uint8),
    (1024, np.uint16, torch.int16),
    (32768, np.uint16, torch.int16),
    (65536, np.uint16, torch.int32),
])
def test_code_dtype_by_codebook_size(K, host, device):
    trie, tables = _tables(K, 3, 12)
    assert tables.unique_codes.dtype == host
    codes = tables_to_torch(tables, "cpu").unique_codes
    assert codes.dtype == device
    assert np.array_equal(codes.long().numpy(), trie.unique_codes)


M, K, BEAMS, DOCS = 16, 1024, 16, 2000


def _search(device, ids, mask):
    cfg = ripor_small(M=M, K=K)
    model = RiporModel(cfg, dtype=torch.float32, device=device)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu", dtype=torch.float32))
    _, tables = _tables(K, M, DOCS)
    fn = make_beam_search_fn(cfg, BEAMS, dtype=torch.float32, device=device)
    return [x.cpu() for x in fn(model, ids, mask, tables_to_torch(tables,
                                                                   device))]


@pytest.mark.cuda
def test_megarow_search_at_1024_codes_on_the_card():
    """The fault's regression test: every search at K = 1,024 raised on
    the card where the codes were uint16. Against the CPU in float32: the
    same codes, the scores within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 512, (3, 10))
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    ids = ids * mask
    card = _search("cuda", ids, mask)
    cpu = _search("cpu", ids, mask)
    assert torch.equal(card[1], cpu[1])
    assert (card[0] - cpu[0]).abs().max() < 1e-4
    assert torch.equal(card[2], cpu[2])
