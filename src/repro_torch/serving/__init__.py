"""Language-model serving steps."""
