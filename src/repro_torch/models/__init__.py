"""Model layers of the port: the dense decoder-only transformer LM."""
