"""Word-vector tokenizer (port of decafnet_tpu/data/tokenizer.py).

Embeds a sentence as the (dim, n_words) matrix of its GloVe vectors after
torchtext ``basic_english`` normalization (lowercase, punctuation split),
with zero vectors for unknown words. Only used when token features are not
precomputed; the live datasets ship precomputed CLIP token features.
"""

from __future__ import annotations

import os
import re

import numpy as np

_PATTERNS = [
    (re.compile(r"\'"), " '  "),
    (re.compile(r"\""), ""),
    (re.compile(r"\."), " . "),
    (re.compile(r"<br \/>"), " "),
    (re.compile(r","), " , "),
    (re.compile(r"\("), " ( "),
    (re.compile(r"\)"), " ) "),
    (re.compile(r"\!"), " ! "),
    (re.compile(r"\?"), " ? "),
    (re.compile(r"\;"), " "),
    (re.compile(r"\:"), " "),
    (re.compile(r"\s+"), " "),
]

# downloads land in the checkout's build/ directory
_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "glove")


def basic_english_tokenize(text):
    """torchtext ``basic_english``: lowercase, split punctuation, split on
    whitespace."""
    text = text.lower()
    for pattern, repl in _PATTERNS:
        text = pattern.sub(repl, text)
    return text.strip().split()


class GloVeTokenizer:
    """Embeds a sentence as a (dim, n_words) matrix of word vectors."""

    def __init__(self, vectors_path, dim=None, max_words=None):
        """Args:
          vectors_path: GloVe-format text file (word + floats per line).
          dim: expected vector dimension (lines of another width are skipped).
          max_words: optionally cap the vocabulary.
        """
        self.vocab = {}
        self.dim = dim
        with open(vectors_path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                if max_words is not None and i >= max_words:
                    break
                parts = line.rstrip().split(" ")
                vec = np.asarray(parts[1:], np.float32)
                if self.dim is None:
                    self.dim = len(vec)
                if len(vec) != self.dim:
                    continue
                self.vocab[parts[0]] = vec
        if not self.dim:
            raise ValueError(f"empty vector file {vectors_path}")
        self._zero = np.zeros((self.dim,), np.float32)

    def lookup(self, word):
        """Unknown words get the zero vector; lowercase as backup."""
        if word in self.vocab:
            return self.vocab[word]
        return self.vocab.get(word.lower(), self._zero)

    def __call__(self, text, max_len=None):
        words = basic_english_tokenize(text) or [""]
        feats = np.stack([self.lookup(w) for w in words])
        if max_len is not None:
            feats = feats[:max_len]
        return np.ascontiguousarray(feats.T)  # (c, t)


TOKENIZERS = {"glove": GloVeTokenizer}

GLOVE_URLS = {
    "6B": "https://huggingface.co/stanfordnlp/glove/resolve/main/"
          "glove.6B.zip",
}
_DEFAULT_GLOVE_DIM = {"6B": 300}  # torchtext's GloVe(name='6B') default


def fetch_glove(name="6B", dim=None, cache_dir=None):
    """Download (once) and extract GloVe vectors; returns the local txt
    path. A warm cache never touches the network; a failed download raises
    naming the url and the cache."""
    import urllib.error
    import urllib.request
    import zipfile

    dim = dim or _DEFAULT_GLOVE_DIM[name]
    cache_dir = cache_dir or _CACHE_DIR
    txt = os.path.join(cache_dir, f"glove.{name}.{dim}d.txt")
    if os.path.exists(txt):
        return txt
    os.makedirs(cache_dir, exist_ok=True)
    url = GLOVE_URLS[name]
    archive = os.path.join(cache_dir, os.path.basename(url))
    if not os.path.exists(archive):
        tmp = archive + ".part"
        try:
            urllib.request.urlretrieve(url, tmp)
        except (urllib.error.URLError, OSError) as e:
            raise RuntimeError(
                f"GloVe auto-fetch from {url} failed ({e}); download "
                f"manually and pass vectors_path, or warm {cache_dir}"
            ) from e
        os.replace(tmp, archive)
    with zipfile.ZipFile(archive) as z:
        member = os.path.basename(txt)
        names = z.namelist()
        if member not in names:
            raise RuntimeError(
                f"{archive} has no {member}; archive contains {names}")
        z.extract(member, cache_dir)
    return txt


def make_tokenizer(spec):
    """``spec``: None, a name ('glove' fetches GloVe-6B), or a {name,
    **kwargs} dict with ``vectors_path`` or the fetch kwargs ``fetch`` /
    ``dim`` / ``cache_dir``."""
    if spec is None:
        return None
    if isinstance(spec, str):
        spec = {"name": spec}
    spec = dict(spec)
    name = spec.pop("name")
    if name == "glove" and "vectors_path" not in spec:
        spec["vectors_path"] = fetch_glove(
            spec.pop("fetch", "6B"), dim=spec.get("dim"),
            cache_dir=spec.pop("cache_dir", None))
    return TOKENIZERS[name](**spec)
