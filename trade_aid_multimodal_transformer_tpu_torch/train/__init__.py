"""Training: steps and optimizer, evaluation, metrics, checkpoints and the
end-to-end runner."""
