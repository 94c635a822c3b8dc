"""Mistral's ``config.json`` keys (``MistralForCausalLM``): RMSNorm,
half-split RoPE, grouped-query attention, a SwiGLU MLP, an untied head."""

from ..reference.common import Dims

# the CPU tests' size
TINY = dict(hidden_size=64, intermediate_size=160, num_attention_heads=4,
            num_key_value_heads=2, num_hidden_layers=2, vocab_size=256,
            sliding_window=64)
TINY_ASSUMED = dict(seq_len=64, train_batch=4, token_ids_below=256)


def dims(c: dict) -> Dims:
    a = c["assumed"]
    window = c.get("sliding_window")
    if window is not None and window < a["seq_len"]:
        raise ValueError(f"sliding_window {window} is shorter than seq_len "
                         f"{a['seq_len']}: full causal attention would not "
                         "be the model's attention")
    if c["hidden_act"] != "silu":
        raise ValueError(f"hidden_act {c['hidden_act']!r}: SwiGLU is silu")
    return Dims(family="mistral", d_model=c["hidden_size"],
                n_layers=c["num_hidden_layers"],
                n_heads=c["num_attention_heads"],
                n_kv_heads=c["num_key_value_heads"],
                head_dim=c["hidden_size"] // c["num_attention_heads"],
                d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                seq_len=a["seq_len"], max_positions=a["seq_len"],
                norm="rmsnorm", norm_eps=c["rms_norm_eps"],
                activation="swiglu", positions="rope",
                rope_theta=c["rope_theta"],
                tie_embeddings=c["tie_word_embeddings"],
                init_std=c["initializer_range"], z_loss=a["z_loss"],
                token_ids_below=a["token_ids_below"])
