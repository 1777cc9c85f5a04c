"""Models: WeightPredictor, its layers, learned SR inference."""
