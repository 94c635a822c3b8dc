"""GPT-2's ``config.json`` keys (``GPT2LMHeadModel``): LayerNorm, learned
positions, multi-head attention, a tanh-GELU MLP, a tied head."""

from ..reference.common import Dims

# the CPU tests' size
TINY = dict(n_embd=64, n_head=2, n_layer=2, n_positions=128, vocab_size=320)
TINY_ASSUMED = dict(seq_len=64, train_batch=4, token_ids_below=300)


def dims(c: dict) -> Dims:
    a = c["assumed"]
    if c["activation_function"] != "gelu_new":
        raise ValueError("GPT-2's gelu_new is the tanh GELU; got "
                         f"{c['activation_function']!r}")
    if any(c[k] for k in ("attn_pdrop", "embd_pdrop", "resid_pdrop")):
        raise ValueError("the port has no dropout: the rates must be 0")
    return Dims(family="gpt2", d_model=c["n_embd"], n_layers=c["n_layer"],
                n_heads=c["n_head"], n_kv_heads=c["n_head"],
                head_dim=c["n_embd"] // c["n_head"], d_ff=4 * c["n_embd"],
                vocab=c["vocab_size"], seq_len=a["seq_len"],
                max_positions=c["n_positions"], norm="layernorm",
                norm_eps=c["layer_norm_epsilon"], activation="gelu_tanh",
                positions="learned", rope_theta=0.0, tie_embeddings=True,
                init_std=c["initializer_range"], z_loss=a["z_loss"],
                token_ids_below=a["token_ids_below"])
