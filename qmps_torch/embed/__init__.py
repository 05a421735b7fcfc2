from .unitaries import (  # noqa: F401
    environment_from_unitary,
    environment_to_unitary,
    get_env_off_left_site,
    get_env_off_right_site,
    put_env_on_left_site,
    put_env_on_right_site,
    tensor_to_unitary,
    unitary_to_tensor,
)
