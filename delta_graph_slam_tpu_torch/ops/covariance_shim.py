"""Lazy bridge to the covariance regularizer (avoids an ops<->register cycle)."""


def regularize(cov, mode):
    from ..register.covariance import regularize_covariances

    return regularize_covariances(cov, mode=mode)
