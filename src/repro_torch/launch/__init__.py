"""Entry points: the LM prefill step and the training launcher."""
