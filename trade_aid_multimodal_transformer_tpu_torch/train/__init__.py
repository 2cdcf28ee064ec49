"""Training-side modules; this slice ports the checkpoint format only."""
