"""GNN configurations of the port."""
