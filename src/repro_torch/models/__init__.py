"""The port's model substrates: FM recsys serving (K4), the GIN forward
(K5) and the transformer LM's prefill and decode serving (``transformer``:
dense and MoE, on K6 and, for the MoE combine, K5's bf16-row form; the
bf16 or the int8 KV cache, the latter on K6's int8 decode form).
Training, the expert-parallel MoE, the other GNN archs and the other LM
configs wait (ROADMAP)."""
