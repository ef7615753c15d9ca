"""GNN models on the Libra operators (forward; training is the next slice)."""
