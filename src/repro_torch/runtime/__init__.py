"""The training loop's fault tolerance: checkpoint/restart supervision and
straggler detection."""
