"""The two text models of ``test_torch_text_hapi.py``, written once
against either package's 2.0 API (``p`` is ``paddle_tpu`` or
``paddle_tpu_torch``), at any width:

- ``Seq2Seq``: Transformer NMT (Vaswani et al. 2017): a shared
  source / target embedding scaled by sqrt(d_model) plus fixed sinusoidal
  positions (an embedding that does not train, as Paddle's Transformer
  example feeds them), ``nn.Transformer``, a causal decoder mask, and
  the output projection tied to the embedding;
- ``LanguageModel``: the PTB LSTM language model (Zaremba et al. 2014):
  embedding, dropout, a multi-layer ``nn.LSTM`` with dropout between
  its layers, dropout, a vocabulary-wide ``Linear``;
- ``SmoothedCrossEntropy``: soft-label cross entropy on
  ``label_smooth(one_hot(label))``, as Paddle's Transformer example
  computes its loss.

Data: ``reversal_pairs`` makes source / target pairs (the target is the
reversed source, fed shifted by BOS), ``Windows`` turns ``Imikolov``
NGRAM windows into (input, next-token label) pairs.
"""
import numpy as np


def sinusoid_table(max_len, d_model):
    pos = np.arange(max_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    return np.where(i % 2 == 0, np.sin(angle), np.cos(angle)).astype("f4")


def seq2seq(p, vocab, d_model, nhead, layers, ffn, dropout, max_len):
    class Seq2Seq(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.d_model = d_model
            self.emb = p.nn.Embedding(vocab, d_model)
            self.pos = p.nn.Embedding(max_len, d_model, weight_attr=p.ParamAttr(
                initializer=p.initializer.NumpyArrayInitializer(
                    sinusoid_table(max_len, d_model)), trainable=False))
            self.transformer = p.nn.Transformer(
                d_model, nhead, layers, layers, ffn, dropout)

        def embed(self, ids):
            pos = self.pos(p.arange(ids.shape[1], dtype="int64"))
            return self.emb(ids) * float(np.sqrt(self.d_model)) + pos

        def forward(self, src, tgt):
            mask = self.transformer.generate_square_subsequent_mask(
                tgt.shape[1])
            h = self.transformer(self.embed(src), self.embed(tgt),
                                 tgt_mask=mask)
            return p.matmul(h, self.emb.weight, transpose_y=True)

    return Seq2Seq()


def language_model(p, vocab, hidden, layers, dropout):
    class LanguageModel(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = p.nn.Embedding(vocab, hidden)
            self.drop = p.nn.Dropout(dropout)
            self.lstm = p.nn.LSTM(hidden, hidden, num_layers=layers,
                                  dropout=dropout)
            self.out = p.nn.Linear(hidden, vocab)

        def forward(self, ids):
            h, _ = self.lstm(self.drop(self.emb(ids)))
            return self.out(self.drop(h))

    return LanguageModel()


def smoothed_cross_entropy(p, vocab, epsilon=0.1):
    class SmoothedCrossEntropy(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.ce = p.nn.CrossEntropyLoss(soft_label=True)

        def forward(self, logits, label):
            return self.ce(logits, p.nn.functional.label_smooth(
                p.nn.functional.one_hot(label, vocab), epsilon=epsilon))

    return SmoothedCrossEntropy()


def reversal_pairs(n, length, vocab, bos, seed):
    """(source, target input, target label) int64 arrays [n, length]:
    tokens in [bos + 1, vocab); the label is the reversed source, the
    target input the label shifted right behind BOS."""
    rs = np.random.RandomState(seed)
    src = rs.randint(bos + 1, vocab, (n, length)).astype("int64")
    label = src[:, ::-1].copy()
    tgt = np.concatenate([np.full((n, 1), bos, "int64"), label[:, :-1]], 1)
    return src, tgt, label


class Windows:
    """``Imikolov`` NGRAM windows as (ids[:-1], ids[1:, None]) pairs:
    the input and the next-token labels."""

    def __init__(self, ngrams):
        self.ngrams = ngrams

    def __getitem__(self, i):
        w = self.ngrams[i]
        return w[:-1], w[1:, None]

    def __len__(self):
        return len(self.ngrams)
