"""Paged KV block pool and its host / disk tiers."""
