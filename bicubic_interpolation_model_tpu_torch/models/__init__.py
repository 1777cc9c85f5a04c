"""Models: WeightPredictor, the direct-regression SR models (ESPCN, ESRGAN, SRResNetTPU), the MLP weight predictors, their layers, learned SR inference."""
