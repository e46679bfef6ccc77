"""The port's model substrates: FM recsys serving (K4) and the GIN
forward (K5).  Training, the other GNN archs and the transformer wait
(ROADMAP)."""
