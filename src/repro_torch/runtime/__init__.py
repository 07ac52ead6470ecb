"""The restart loop and the straggler monitor of a training run."""
