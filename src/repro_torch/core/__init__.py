"""Host-side RAGCache policy: knowledge tree, controller, reorder, speculation."""
