"""Dataset configurations of the paper's evaluation."""
