"""Cross-cutting utilities: linear algebra, random sampling, bit ops,
reordering, GMM, recall."""
