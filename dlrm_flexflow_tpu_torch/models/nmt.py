"""NMT LSTM seq2seq (the counterpart of ``dlrm_flexflow_tpu.models.nmt``):
reversed source -> embedding -> stacked encoder LSTMs; target embeddings
concatenated with the encoder's outputs, position by position -> stacked
decoder LSTMs -> a per-position dense softmax over the target vocabulary.
Op for op and name for name the JAX graph, so ``params_from_jax``
carries a JAX model's weights across."""

from __future__ import annotations

import torch

from ..core.model import FFModel


def build_nmt(model: FFModel, src_vocab: int = 32 * 1024,
              tgt_vocab: int = 32 * 1024, embed_dim: int = 1024,
              hidden: int = 1024, num_layers: int = 2,
              src_len: int = 40, tgt_len: int = 40):
    """Shapes default to the reference's scale (sequences of 40,
    1024-wide cells, a 32k vocabulary). Returns ({input name: shape},
    the probabilities tensor (batch·tgt_len, tgt_vocab))."""
    batch = model.config.batch_size
    src = model.create_tensor((batch, src_len), dtype=torch.int64,
                              name="src")
    tgt = model.create_tensor((batch, tgt_len), dtype=torch.int64,
                              name="tgt")

    rsrc = model.reverse(src, axis=1, name="src_rev")
    senc = model.embedding(rsrc, src_vocab, embed_dim, aggr="none",
                           name="src_embed")                  # (b, s, e)
    enc_out = model.lstm_stack(senc, hidden, num_layers,
                               name="enc_lstm")               # (b, s, h)

    demb = model.embedding(tgt, tgt_vocab, embed_dim, aggr="none",
                           name="tgt_embed")
    # the decoder is conditioned on the encoder by concatenating its
    # outputs with the target embeddings, position by position
    if src_len != tgt_len:
        raise ValueError("this NMT build uses src_len == tgt_len")
    d = model.concat([demb, enc_out], axis=2, name="dec_in")
    d = model.lstm_stack(d, hidden, num_layers, name="dec_lstm")
    # per-position logits: fold seq into batch for the big projection
    d2 = model.reshape(d, (batch * tgt_len, hidden), name="dec_fold")
    logits = model.dense(d2, tgt_vocab, name="proj")
    probs = model.softmax(logits, name="prob")
    return {"src": (batch, src_len), "tgt": (batch, tgt_len)}, probs
