"""Training-side modules the serving path needs: checkpoint restore."""
