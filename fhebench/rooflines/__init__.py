"""The least time of a layer's work, counted from the program's FHE
operations at their shapes (fhe_ops) with the card's rates (bounds)."""
