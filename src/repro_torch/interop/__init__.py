"""Adapters to other libraries (scikit-learn); each imports its library lazily."""
