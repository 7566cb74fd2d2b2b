"""Model-side execution context (no mesh yet: one card)."""
