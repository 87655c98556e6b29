"""``paddle.text.datasets``: NLP and tabular dataset loaders.

Counterpart of ``paddle_tpu/text/datasets.py`` (reference
python/paddle/text/datasets/: UCIHousing, Imdb, Imikolov), item for
item: the parsing, the vocabularies (cutoff, ordering, ``<unk>``) and
the splits are the JAX package's.  The loaders read a local
``data_file`` only: ``download=True`` raises with the upstream URL.
"""
from __future__ import annotations

import os
import re
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["UCIHousing", "Imdb", "Imikolov"]

UCI_URL = "http://paddlemodels.bj.bcebos.com/uci_housing/housing.data"
IMDB_URL = "https://dataset.bj.bcebos.com/imdb%2FaclImdb_v1.tar.gz"
IMIKOLOV_URL = "https://dataset.bj.bcebos.com/imikolov%2Fsimple-examples.tgz"


def _require_file(data_file, url, name):
    if data_file is None:
        raise RuntimeError(
            f"{name}: the loaders read local files only and download "
            f"nothing; fetch {url} yourself and pass data_file=...")
    if not os.path.exists(data_file):
        raise FileNotFoundError(f"{name}: data_file {data_file!r} not found")
    return data_file


class UCIHousing(Dataset):
    """UCI housing regression set (reference text/datasets/uci_housing.py):
    13 features + target, 80/20 train/test split, feature-wise max-min
    normalization computed on the full data (reference semantics)."""

    def __init__(self, data_file=None, mode="train", download=False):
        data_file = _require_file(data_file, UCI_URL, "UCIHousing")
        raw = np.loadtxt(data_file).astype("float32")
        # reference feature normalization: (x - avg) / (max - min)
        maxs, mins, avgs = raw.max(0), raw.min(0), raw.mean(0)
        feat = (raw - avgs) / (maxs - mins)
        feat[:, -1] = raw[:, -1]  # target stays raw
        split = int(raw.shape[0] * 0.8)
        data = feat[:split] if mode == "train" else feat[split:]
        self.data = data[:, :-1]
        self.label = data[:, -1:].astype("float32")

    def __getitem__(self, idx):
        return self.data[idx], self.label[idx]

    def __len__(self):
        return len(self.data)


_TOKENIZE = re.compile(r"\w+|[<>]+")


class Imdb(Dataset):
    """IMDB sentiment set from the aclImdb tarball (reference
    text/datasets/imdb.py): word-frequency vocabulary with a cutoff,
    <unk> index = len(vocab)."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=False):
        data_file = _require_file(data_file, IMDB_URL, "Imdb")
        self._tar = data_file
        self.word_idx = self._build_vocab(cutoff)
        pat = re.compile(rf"aclImdb/{mode}/(pos|neg)/.*\.txt$")
        self.docs, self.labels = [], []
        unk = len(self.word_idx)
        with tarfile.open(self._tar) as tf:
            for m in tf.getmembers():
                g = pat.match(m.name)
                if not g:
                    continue
                text = tf.extractfile(m).read().decode("latin-1").lower()
                ids = [self.word_idx.get(w, unk)
                       for w in _TOKENIZE.findall(text)]
                self.docs.append(np.asarray(ids, "int64"))
                self.labels.append(
                    np.asarray([0 if g.group(1) == "pos" else 1], "int64"))

    def _build_vocab(self, cutoff):
        from collections import Counter

        freq = Counter()
        pat = re.compile(r"aclImdb/train/(pos|neg)/.*\.txt$")
        with tarfile.open(self._tar) as tf:
            for m in tf.getmembers():
                if pat.match(m.name):
                    text = tf.extractfile(m).read().decode("latin-1").lower()
                    freq.update(_TOKENIZE.findall(text))
        words = [w for w, c in freq.items() if c > cutoff and w != "<unk>"]
        words.sort(key=lambda w: (-freq[w], w))
        return {w: i for i, w in enumerate(words)}

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB n-gram set (reference text/datasets/imikolov.py): n-grams from
    simple-examples with <s>/<e> markers."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50, download=False):
        data_file = _require_file(data_file, IMIKOLOV_URL, "Imikolov")
        self.window_size = window_size
        self.data_type = data_type.upper()
        name = f"./simple-examples/data/ptb.{ 'train' if mode == 'train' else 'valid'}.txt"
        from collections import Counter

        with tarfile.open(data_file) as tf:
            trn = tf.extractfile(
                "./simple-examples/data/ptb.train.txt").read().decode()
            txt = tf.extractfile(name).read().decode()
        freq = Counter(trn.split())
        freq = {w: c for w, c in freq.items() if c >= min_word_freq}
        words = sorted(freq, key=lambda w: (-freq[w], w))
        self.word_idx = {w: i for i, w in enumerate(words)}
        self.word_idx["<unk>"] = len(self.word_idx)
        unk = self.word_idx["<unk>"]
        self.data = []
        for line in txt.splitlines():
            toks = ["<s>"] + line.split() + ["<e>"]
            ids = [self.word_idx.get(w, unk) for w in toks]
            if self.data_type == "NGRAM":
                for i in range(len(ids) - window_size + 1):
                    self.data.append(
                        np.asarray(ids[i:i + window_size], "int64"))
            else:  # SEQ
                self.data.append((np.asarray(ids[:-1], "int64"),
                                  np.asarray(ids[1:], "int64")))

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)
