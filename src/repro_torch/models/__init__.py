"""The port's model substrates: FM recsys serving (K4), the GIN forward
(K5) and the dense transformer LM's prefill and decode serving (K6,
``transformer``).  Training, MoE, the other GNN archs and the other LM
configs wait (ROADMAP)."""
