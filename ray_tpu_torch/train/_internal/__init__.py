"""The Train stack's internals: the worker group and the backend executor."""
