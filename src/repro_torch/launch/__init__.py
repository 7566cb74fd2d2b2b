"""Step functions of the model path."""
