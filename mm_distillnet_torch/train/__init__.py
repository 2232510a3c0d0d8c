"""Training orchestration; so far only the config mapping that evaluation needs."""
