"""Device segment mirror, ranking weight schemes, and the host segment
builder and merge (``builder.py``, ``merge.py``: pinned copies of the JAX
package's) - torch port."""
