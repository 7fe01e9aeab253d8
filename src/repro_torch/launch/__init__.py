"""Entry points for the LM path: step functions and the serving loop."""
