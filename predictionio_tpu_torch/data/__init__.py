"""Data layer of the port: events, the ID vocabularies, the columnar
training read, the synthetic rating generator and storage (memory, SQLite,
local files)."""
