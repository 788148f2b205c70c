"""The port's copy of the hash tokenizer (``data.tokenizer``), bitwise
against ``repro.data.tokenizer`` on tests/test_data.py's cases and on
text drawn by hypothesis (the FNV hash, the word and sub-word splits,
the modulus)."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro_torch.data.tokenizer import HashTokenizer
import torch_threads  # noqa: F401  (PyTorch threads per test process)

CASES = ("Neural Information Retrieval with segments!", "Apple", "apple",
         "extraordinarily", "the quick brown fox jumps over a lazy dog " * 10,
         "", "   ", "naïve café — ÜBER 3.14e-2 ##x", "a" * 40)
KWARGS = ({}, {"max_subword": 4}, {"n_raw_tokens": 1000},
          {"n_raw_tokens": 7, "max_subword": 1})


def _same(text, kw):
    got = HashTokenizer(**kw).tokenize(text)
    want = JaxTokenizer(**kw).tokenize(text)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("kw", KWARGS)
@pytest.mark.parametrize("text", CASES)
def test_cases_match_reference(text, kw):
    toks = _same(text, kw)
    n = kw.get("n_raw_tokens", 2**17)
    assert toks.size == 0 or (toks.min() >= 0 and toks.max() < n)


def test_reference_properties_hold():
    """tests/test_data.py::TestTokenizer on the port."""
    t = HashTokenizer()
    assert t.tokenize("Apple")[0] == t.tokenize("apple")[0]
    assert HashTokenizer(max_subword=4).tokenize("extraordinarily").size > 1
    np.testing.assert_array_equal(t.tokenize("Neural segments!"),
                                  t.tokenize("Neural segments!"))


def test_corpus_matches_reference():
    got = HashTokenizer().tokenize_corpus(CASES)
    want = JaxTokenizer().tokenize_corpus(CASES)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@settings(max_examples=300, deadline=None, database=None)
@given(text=st.text(max_size=200),
       n_raw=st.integers(min_value=1, max_value=2**20),
       max_subword=st.integers(min_value=1, max_value=12))
def test_drawn_text_matches_reference(text, n_raw, max_subword):
    _same(text, dict(n_raw_tokens=n_raw, max_subword=max_subword))
