"""Training: losses, optimizer, state and the CLIP+SSL+rec train step."""
