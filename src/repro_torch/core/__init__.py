"""Host format construction and the PackSELL / SELL matrices on tensors."""
