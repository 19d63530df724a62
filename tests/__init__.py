"""Test suite (a package, so that `tests` resolves to this directory even
where another installed distribution ships a top-level `tests`)."""
