package MXNetTPU;

# Perl predict-only frontend over the port's predict ABI (mirrors
# bindings/perl/lib/MXNetTPU.pm; parity model: the reference's
# matlab/+mxnet/model.m — load a checkpoint, feed inputs, read outputs).
#
#   my $p = MXNetTPU::Predictor->new(
#       symbol_file => "m-symbol.json", params_file => "m-0000.params",
#       input_key => "data", input_shape => [4, 8],
#       dev_type => 2, dev_id => 0);          # default: 1, the CPU
#   my $out = $p->predict([ @flat_row_major_floats ]);   # array ref
#   my $raw = $p->predict_packed(pack("f<*", @floats));  # float32 bytes
#   my $shape = $p->output_shape;                        # array ref

use strict;
use warnings;

our $VERSION = '0.1';

# RTLD_GLOBAL: the predict library embeds CPython; the interpreter's own
# extension modules resolve libpython symbols from the global namespace,
# so the chain must be loaded globally.  Defining dl_load_flags makes
# XSLoader delegate to DynaLoader, which honors it.
sub dl_load_flags { 0x01 }

require XSLoader;
XSLoader::load('MXNetTPU', $VERSION);

package MXNetTPU::Predictor;

use strict;
use warnings;
use Carp ();

sub new {
    my ($class, %args) = @_;
    for my $k (qw(symbol_file params_file input_key input_shape)) {
        Carp::croak("MXNetTPU::Predictor->new: missing $k")
            unless defined $args{$k};
    }
    my $sym    = _slurp($args{symbol_file});
    my $params = _slurp($args{params_file});
    my $handle = MXNetTPU::_create($sym, $params, $args{input_key},
                                   $args{input_shape},
                                   $args{dev_type} // 1,
                                   $args{dev_id} // 0);
    return bless {
        handle => $handle,
        key    => $args{input_key},
    }, $class;
}

sub predict {
    my ($self, $data) = @_;
    MXNetTPU::_set_input($self->{handle}, $self->{key}, $data);
    MXNetTPU::_forward($self->{handle});
    return MXNetTPU::_output($self->{handle}, 0, $self->_total(0));
}

sub predict_packed {
    my ($self, $bytes) = @_;
    MXNetTPU::_set_input_packed($self->{handle}, $self->{key}, $bytes);
    MXNetTPU::_forward($self->{handle});
    return MXNetTPU::_output_packed($self->{handle}, 0, $self->_total(0));
}

sub output_shape {
    my ($self, $index) = @_;
    return MXNetTPU::_output_shape($self->{handle}, $index // 0);
}

sub _total {
    my ($self, $index) = @_;
    my $total = 1;
    $total *= $_ for @{ $self->output_shape($index) };
    return $total;
}

sub DESTROY {
    my ($self) = @_;
    MXNetTPU::_free($self->{handle}) if $self->{handle};
    $self->{handle} = 0;
}

sub _slurp {
    my ($path) = @_;
    open my $fh, '<:raw', $path
        or Carp::croak("MXNetTPU: cannot read $path: $!");
    local $/;
    my $data = <$fh>;
    close $fh;
    return $data;
}

1;
