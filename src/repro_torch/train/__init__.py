"""Training: the loss, its gradients and the optimizer step (``step``)
and the checkpointing, preemption-aware trainer (``trainer``)."""
