"""The hand-written CUDA kernel on the card, held against its plain
PyTorch version.  Every test here needs an NVIDIA card (marker ``gpu``)
and skips without one.  This file imports no JAX, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from annchor_tpu_torch import Annchor
from annchor_tpu_torch.datasets import make_strings
from annchor_tpu_torch.ops.device_pipeline import default_uniforms
from annchor_tpu_torch.ops.levenshtein import encode_strings, levenshtein_scalar
from annchor_tpu_torch.ops.levenshtein_cuda import K1, myers_pairs_cuda
from annchor_tpu_torch.ops.levenshtein_myers import (
    MyersEncoding,
    myers_pairs,
    myers_pairs_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _strings(rng, n, lo, hi, alphabet):
    chars = list(alphabet)
    return [
        "".join(rng.choice(chars, size=int(rng.integers(lo, hi + 1))))
        for _ in range(n)
    ]


@pytest.mark.parametrize(
    "alphabet,lo,hi",
    [("ab", 0, 70), ("ACGT", 426, 550), ("abcdefghijklmnopqrstuvwxyz", 0, 140),
     ("ACGT", 2100, 2300)],
)
def test_k1_bit_equal_to_plain(cuda, alphabet, lo, hi):
    rng = np.random.default_rng(len(alphabet) + hi)
    strs = _strings(rng, 64, lo, hi, alphabet)
    strs[0] = ""
    strs[1] = "a" * 33
    enc = MyersEncoding.from_codes(*encode_strings(strs), cuda)
    I = torch.as_tensor(rng.integers(0, 64, size=3000), device=cuda)
    J = torch.as_tensor(rng.integers(0, 64, size=3000), device=cuda)
    before = K1.launches
    got = myers_pairs(enc, I, J)
    torch.cuda.synchronize()
    assert K1.launches > before
    assert torch.equal(got, myers_pairs_plain(enc, I, J))
    Ih, Jh = I[:16].tolist(), J[:16].tolist()
    want = [levenshtein_scalar(strs[i], strs[j]) for i, j in zip(Ih, Jh)]
    assert got[:16].tolist() == want


def test_k1_wrapper_checks_inputs(cuda):
    enc = MyersEncoding.from_codes(*encode_strings(["ab", "abc"]), cuda)
    I = torch.zeros(2, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        myers_pairs_cuda(enc.peq.float(), enc.ids, enc.lengths, I, I)
    with pytest.raises(ValueError):
        myers_pairs_cuda(enc.peq, enc.ids, enc.lengths, I.cpu(), I)
    with pytest.raises(ValueError):
        myers_pairs_cuda(enc.peq, enc.ids[:, ::2], enc.lengths, I, I)


def test_fit_on_card_equals_fit_on_cpu(cuda):
    """The same small fit, with the same uniforms, on the card (K1) and
    on the CPU (plain versions): same anchors, evals and graph."""
    X, _ = make_strings(n=300, length=60, seed=7)
    kw = dict(n_anchors=12, n_neighbors=10, n_samples=800, p_work=0.3)

    def uniforms(seed, loop, m, device):
        return default_uniforms(seed, loop, m, "cpu").to(device)

    a = Annchor(list(X), "levenshtein", device="cpu", uniforms=uniforms, **kw)
    a.fit()
    b = Annchor(list(X), "levenshtein", device=cuda, uniforms=uniforms, **kw)
    b.fit()
    np.testing.assert_array_equal(a.A, b.A)
    assert a.evals == b.evals
    np.testing.assert_array_equal(a.neighbor_graph[0], b.neighbor_graph[0])
    np.testing.assert_array_equal(a.neighbor_graph[1], b.neighbor_graph[1])
