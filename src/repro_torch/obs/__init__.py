"""Observability of the port: the structured event schema its session,
fault injector and straggler monitor share (``obs.events``; the JAX
package's telemetry, watchdog and flight recorder are not ported
yet)."""
