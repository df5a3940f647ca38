"""Weight bridges between the JAX package's trees and the port's modules."""
