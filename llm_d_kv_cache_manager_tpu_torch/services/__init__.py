"""Sidecar services (reference: services/); the port's copy of the JAX
package's ``services/``."""
