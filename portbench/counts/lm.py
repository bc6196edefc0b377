"""Model FLOPs of one training step of the decoder LM (PaLM-style, causal).

A frozen copy of ``bluefog_tpu_torch/lm_bench.py``'s ``matmul_param_count``
and ``model_flops``, taken from the configuration's sizes rather than from
a built model:

  matmul parameters: 6 * N_matmul * tokens (forward and backward)
  attention:         12 * L * B * S^2 * d_model * 0.5 (causal half)

N_matmul counts every weight that a product reads (q, k, v, the output
projection, the two FFN weights of each layer, and the untied head) and
leaves out the embedding, which is a gather.
"""


def matmul_params(cfg: dict) -> int:
    d = int(cfg["hidden_size"])
    ff = int(cfg["intermediate_size"])
    L = int(cfg["num_hidden_layers"])
    V = int(cfg["vocab_size"])
    return L * (4 * d * d + 2 * d * ff) + V * d


def step_flops(cfg: dict, batch: int, seq_len: int) -> float:
    d = int(cfg["hidden_size"])
    L = int(cfg["num_hidden_layers"])
    return (6.0 * matmul_params(cfg) * batch * seq_len
            + 12.0 * L * batch * seq_len ** 2 * d * 0.5)
