"""Models of the port: the causal LM the decode engine serves and BERT
pretraining."""
